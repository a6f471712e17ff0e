// K3: exact adaptive-pool ("area") crop-resize of K boxes per frame, the
// R-Net (O=24) and O-Net (O=48) stage crops, as a prep kernel shared by
// both stage crops and a crop kernel per stage crop.
//
// Replaces the Pallas kernel truely_tpu/ops/crop_fused2.py:
// crop_resize_area_fused2 (_kernel, prep prep_frames_fused2).  quant == 1 is
// that kernel's function, truely_tpu/ops/resize.py:crop_resize_area over
// integral_image; quant > 1 is crop_resize_area_mxu_quant: the box snaps to
// the quant-px grid (floor near edge, ceil far edge, an empty box stays
// empty), the bins are cut on the grid of quant x quant blocks, and each
// bin's sum is divided by max(area, 1) * quant^2.
//
// (a) Prep, once per frame step: the integral image of the quant x quant
// block sums, (n, h/q+1, w/q+1, 3), in wrapping uint32.  A bin's
// four-corner difference is exact whenever the bin's own sum fits in 31
// bits, whatever the frame size.  Row pass: one CTA per (frame, block row)
// stages its q source rows through shared memory with 16-byte loads, forms
// the block sums and scans them along the row; column pass: one thread per
// (frame, column, channel) scans down the rows, coalesced across threads.
// Bound by bytes: the frames read once, the integral written and read
// back once by the column pass.
//
// (b) Crop: a CTA computes its box's bin edges once into shared memory;
// then one thread per (bin, channel), four corner loads from the
// integral and one IEEE f32 division in the reference's order,
// (float)sum / (max((float)area, 1) * q*q); zeros for an empty bin.  The
// grid runs frame-major, so one frame's integral (1.56 MB at q=4, 1080p)
// stays in L2 while its boxes are cut.  Bound by bytes: the output written
// once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;        // threads per CTA; block columns per chunk of the row pass
constexpr int kStageBytes = 24576;   // shared bytes of staged source rows
constexpr int kCropItems = 1024;     // (bin, channel) items per CTA of the crop

// Row pass: row r+1 of the integral of frame blockIdx.y holds, for each
// block column j and channel, the sum of the block sums of block row r over
// columns < j.  Column 0 is zero.  chunk block columns (<= kThreads) are
// done at a time, their source bytes staged `stage` rows at a time.
__global__ void __launch_bounds__(kThreads)
integral_rows_kernel(const uint8_t* __restrict__ frames, uint32_t* __restrict__ integ,
                     int h, int w, int q, int chunk, int stage) {
  extern __shared__ __align__(16) uint8_t staged[];  // stage rows of chunk * q * 3 bytes
  __shared__ uint32_t warp_sum[kThreads / 32][3];
  __shared__ uint32_t carry[3];
  const int wq = w / q;
  const int r = blockIdx.x, frame = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t row_bytes = static_cast<size_t>(w) * 3;
  const uint8_t* src = frames + (static_cast<size_t>(frame) * h + static_cast<size_t>(r) * q) * row_bytes;
  uint32_t* dst = integ + (static_cast<size_t>(frame) * (h / q + 1) + r + 1) * (wq + 1) * 3;
  if (t < 3) {
    carry[t] = 0;
    dst[t] = 0;
  }
  for (int c0 = 0; c0 < wq; c0 += chunk) {
    const int cols = min(chunk, wq - c0);
    const int seg = cols * q * 3;  // bytes of one source row in this chunk
    uint32_t s0 = 0, s1 = 0, s2 = 0;
    for (int i0 = 0; i0 < q; i0 += stage) {
      const int nrows = min(stage, q - i0);
      const uint8_t* from = src + i0 * row_bytes + static_cast<size_t>(c0) * q * 3;
      if ((reinterpret_cast<uintptr_t>(from) & 15) == 0 && (row_bytes & 15) == 0 &&
          (seg & 15) == 0) {  // 16-byte loads, neighbouring threads on neighbouring bytes
        const int vecs = seg / 16;
        for (int v = t; v < nrows * vecs; v += blockDim.x) {
          const int i = v / vecs, j = v - i * vecs;
          reinterpret_cast<uint4*>(staged + i * seg)[j] =
              reinterpret_cast<const uint4*>(from + i * row_bytes)[j];
        }
      } else {
        for (int v = t; v < nrows * seg; v += blockDim.x) {
          const int i = v / seg;
          staged[v] = from[i * row_bytes + (v - i * seg)];
        }
      }
      __syncthreads();
      if (t < cols) {
        for (int i = 0; i < nrows; ++i) {
          const uint8_t* p = staged + i * seg + t * q * 3;
          for (int j = 0; j < q; ++j) {
            s0 += p[3 * j];
            s1 += p[3 * j + 1];
            s2 += p[3 * j + 2];
          }
        }
      }
      __syncthreads();
    }
    // Inclusive scan of the chunk's block sums along the row, per channel.
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t a0 = __shfl_up_sync(0xffffffffu, s0, off);
      const uint32_t a1 = __shfl_up_sync(0xffffffffu, s1, off);
      const uint32_t a2 = __shfl_up_sync(0xffffffffu, s2, off);
      if (lane >= off) {
        s0 += a0;
        s1 += a1;
        s2 += a2;
      }
    }
    if (lane == 31) {
      warp_sum[warp][0] = s0;
      warp_sum[warp][1] = s1;
      warp_sum[warp][2] = s2;
    }
    __syncthreads();
    s0 += carry[0];
    s1 += carry[1];
    s2 += carry[2];
    for (int i = 0; i < warp; ++i) {
      s0 += warp_sum[i][0];
      s1 += warp_sum[i][1];
      s2 += warp_sum[i][2];
    }
    if (t < cols) {
      uint32_t* d = dst + static_cast<size_t>(c0 + t + 1) * 3;
      d[0] = s0;
      d[1] = s1;
      d[2] = s2;
    }
    __syncthreads();  // every thread has read carry and warp_sum
    if (t == cols - 1) {
      carry[0] = s0;
      carry[1] = s1;
      carry[2] = s2;
    }
    __syncthreads();
  }
}

// Column pass: zero row 0 and add each row into the next, down the rows of
// one frame (blockIdx.y) for one (column, channel) per thread.
__global__ void __launch_bounds__(kThreads)
integral_cols_kernel(uint32_t* __restrict__ integ, int hq, int wq) {
  constexpr int kDepth = 16;
  const int n = (wq + 1) * 3;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t* p = integ + static_cast<size_t>(blockIdx.y) * (hq + 1) * n + i;
  p[0] = 0;
  uint32_t acc = 0;
  int r = 1;
  for (; r + kDepth <= hq + 1; r += kDepth) {  // kDepth loads in flight per thread
    uint32_t v[kDepth];
#pragma unroll
    for (int j = 0; j < kDepth; ++j) v[j] = p[static_cast<size_t>(r + j) * n];
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      acc += v[j];
      p[static_cast<size_t>(r + j) * n] = acc;
    }
  }
  for (; r <= hq; ++r) {
    acc += p[static_cast<size_t>(r) * n];
    p[static_cast<size_t>(r) * n] = acc;
  }
}

// The box's bounds, snapped to the quant-px grid (floor for the near edge,
// ceil for the far edge; an empty box stays empty).
__device__ __forceinline__ void snapped_bounds(const int* bd, int quant, int& x0, int& y0,
                                               int& x1, int& y1) {
  x0 = bd[0];
  y0 = bd[1];
  x1 = bd[2];
  y1 = bd[3];
  if (quant > 1) {
    const int qx0 = floor_div(x0, quant), qy0 = floor_div(y0, quant);
    x1 = x1 > x0 ? ceil_div(x1, quant) : qx0;
    y1 = y1 > y0 ? ceil_div(y1, quant) : qy0;
    x0 = qx0;
    y0 = qy0;
  }
}

// Adaptive-pool bin i of o over [start, stop):
// [start + floor(i*len/o), start + ceil((i+1)*len/o)), empty when len <= 0.
__device__ __forceinline__ int2 bin_edges(int i, int start, int stop, int o) {
  const int len = max(stop - start, 0);
  const int s = start + (i * len) / o;
  return make_int2(s, max(start + ceil_div((i + 1) * len, o), s));
}

// One CTA per (box, band of `band` output rows), boxes in frame-major
// order.  The box's column edges and the band's row edges are computed once
// into shared memory; then one thread per (bin, channel) item.
__global__ void __launch_bounds__(kThreads)
crop_area_kernel(const uint32_t* __restrict__ integ, const int* __restrict__ bounds,
                 float* __restrict__ out, int hq, int wq, int k, int o, int quant, int band) {
  extern __shared__ int2 edges[];  // o column edges, then band row edges
  const int bands = (o + band - 1) / band;
  const int box = blockIdx.x / bands;  // frame * k + box index
  const int row0 = (blockIdx.x - box * bands) * band;
  const int rows = min(band, o - row0);
  int2* cols = edges;
  int2* rtab = edges + o;
  for (int i = threadIdx.x; i < o + rows; i += blockDim.x) {
    int x0, y0, x1, y1;
    snapped_bounds(bounds + static_cast<size_t>(box) * 4, quant, x0, y0, x1, y1);
    if (i < o) cols[i] = bin_edges(i, x0, x1, o);
    else rtab[i - o] = bin_edges(row0 + i - o, y0, y1, o);
  }
  __syncthreads();

  const int row_len = o * 3;
  float* dst = out + (static_cast<size_t>(box) * o + row0) * row_len;
  const size_t pitch = static_cast<size_t>(wq + 1) * 3;
  const uint32_t* base = integ + static_cast<size_t>(box / k) * (hq + 1) * pitch;
  for (int e = threadIdx.x; e < rows * row_len; e += blockDim.x) {
    const int r = e / row_len, x = (e - r * row_len) / 3;
    const int c = e - r * row_len - x * 3;
    const int2 ty = rtab[r], tx = cols[x];
    const int area = (ty.y - ty.x) * (tx.y - tx.x);
    if (area <= 0) {  // empty bin (boxes outside the frame land here too)
      dst[e] = 0.0f;
      continue;
    }
    // Corner indices clamped like the reference's gathers (a nonempty bin
    // of clipped bounds is inside already).
    const uint32_t* top = base + static_cast<size_t>(min(max(ty.x, 0), hq)) * pitch + c;
    const uint32_t* bot = base + static_cast<size_t>(min(max(ty.y, 0), hq)) * pitch + c;
    const int xs = min(max(tx.x, 0), wq) * 3, xe = min(max(tx.y, 0), wq) * 3;
    const uint32_t sum = bot[xe] - top[xe] - bot[xs] + top[xs];
    const float denom = fmaxf(static_cast<float>(area), 1.0f) * static_cast<float>(quant * quant);
    dst[e] = static_cast<float>(static_cast<int>(sum)) / denom;
  }
}

}  // namespace

// frames (n, h, w, 3) u8 with h and w multiples of quant; integ
// (n, h/quant+1, w/quant+1, 3) 32-bit.
extern "C" int tt_crop_area_integral(const void* frames, void* integ, int n, int h, int w,
                                     int quant, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hq = h / quant, wq = w / quant;
  const int chunk = max(1, min(kThreads, kStageBytes / (3 * quant)));
  const int stage = max(1, min(quant, kStageBytes / (3 * quant * chunk)));
  if (hq > 0 && wq > 0) {
    integral_rows_kernel<<<dim3(hq, n), kThreads, static_cast<size_t>(stage) * chunk * quant * 3, s>>>(
        static_cast<const uint8_t*>(frames), static_cast<uint32_t*>(integ), h, w, quant, chunk,
        stage);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int cols = (wq + 1) * 3;
  integral_cols_kernel<<<dim3((cols + kThreads - 1) / kThreads, n), kThreads, 0, s>>>(
      static_cast<uint32_t*>(integ), hq, wq);
  return static_cast<int>(cudaGetLastError());
}

// integ from tt_crop_area_integral (hq = h/quant, wq = w/quant); bounds
// (n, k, 4) int32 half-open (x0, y0, x1, y1) clipped to the frame; out
// (n, k, o, o, 3) f32.
extern "C" int tt_crop_area(const void* integ, const void* bounds, void* out, int n, int hq,
                            int wq, int k, int o, int quant, void* stream) {
  // About kCropItems (bin, channel) items per CTA: 2 bands a box at O=24,
  // 7 at O=48.
  const int band = max(1, min(o, kCropItems / (3 * max(o, 1))));
  const int bands = (o + band - 1) / band;
  if (n * k == 0 || o == 0) return 0;
  crop_area_kernel<<<n * k * bands, kThreads, static_cast<size_t>(o + band) * sizeof(int2),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(integ), static_cast<const int*>(bounds),
      static_cast<float*>(out), hq, wq, k, o, quant, band);
  return static_cast<int>(cudaGetLastError());
}
