// K5: exact adaptive-pool ("area") crop-resize of K boxes per frame, the
// R-Net (O=24) and O-Net (O=48) stage crops on the exact crop chain
// (use_fused_crops=1, q=1), read straight from the (n, h, w, 3) frames.
//
// Replaces the Pallas kernel truely_tpu/ops/crop_area_fused.py:
// crop_resize_area_fused (_crop_kernel, prep prep_frames_for_fused_crops).
// The TPU kernel shifts a planar, W-major copy of the frame to int8, splits
// column sums into bf16 hi/lo halves and computes all (k, k') cross-blocks
// of a second matrix product to keep the diagonal, because its matrix unit
// has no integer path.  Its idea, the bin sums held on chip, is kept; the
// rest is not: int32 sums of uint8 are exact on the card, and no copy of
// the frame is made.
//
// Design: one CTA per (group of `ybins` y-bins, box, frame); the wrapper
// takes one y-bin per CTA in a small launch and up to four in a large one
// (ops/crop_area_fused.py:y_bins_per_cta).  It computes
// the box's x-bin edges and its y-bins' edges once into shared memory.
// The box's row in the frame is 3 * width contiguous bytes for all three
// channels; it is cut into 16-byte chunks (from the crop's first byte
// rounded down to 16).  A work item is (y-bin, chunk): its thread reads the
// chunk of each row of the y-bin with 16-byte loads, eight rows in flight,
// and keeps 16 byte-column sums in registers; those go to shared memory.
// Then one thread per (y-bin, x-bin, channel) adds the columns of its bin
// (the bin's part inside the frame) and does one IEEE float32 division,
// (float)sum / max((float)area, 1), the reference's order; empty bins give
// zeros.  No atomics, and the only integer divisions are one per work item
// and the constant 3.  Adaptive-pool bins overlap by a pixel at
// non-integer edges, and a crop narrower than O puts a pixel in several
// bins: each y-bin reads its rows [s, e) and each x-bin adds its columns
// [s, e), whatever other bins hold them.  Frames whose rows are not
// 16-byte aligned take the same kernel with byte loads.
//
// Bound on the H100 by bytes: each crop pixel is read from memory once per
// y-bin that holds its row (once, plus the shared edge rows); crops that
// overlap re-read their common pixels, mostly from L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxYBins = 8;    // y-bins of one box per CTA, at most
constexpr int kMaxO = 256;      // x-bin table capacity
constexpr int kRows = 8;        // rows of a chunk in flight per thread
constexpr int kSumInts = 8192;  // least shared column sums (32 KB)

// Adaptive-pool bin i of o over [start, stop):
// [start + floor(i*len/o), start + ceil((i+1)*len/o)), empty when len <= 0.
__device__ __forceinline__ int2 bin_edges(int i, int start, int stop, int o) {
  const int len = max(stop - start, 0);
  const int s = start + (i * len) / o;
  return make_int2(s, max(start + ceil_div((i + 1) * len, o), s));
}

// The 16 bytes at p; without kVec byte by byte, and only those whose
// position pos + b in the row lies in [lo, hi) (the others read as 0).
template <bool kVec>
__device__ __forceinline__ uint4 load16(const uint8_t* p, int pos, int lo, int hi) {
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (pos + b >= lo && pos + b < hi) v[b >> 2] |= static_cast<uint32_t>(p[b]) << (8 * (b & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void add_bytes(int* acc, uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[4 * q + b] += __byte_perm(w[q], 0u, 0x4440u + b);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
crop_area_fused_kernel(const uint8_t* __restrict__ frames, const int* __restrict__ bounds,
                       float* __restrict__ out, int h, int w, int k, int o, int ybins,
                       int cap) {
  __shared__ int2 xt[kMaxO];  // x-bin edges
  __shared__ int2 yt[kMaxYBins];  // this CTA's y-bin edges
  extern __shared__ int sums[];  // (y-bin, byte % 16, chunk) column sums, cap ints
  const int box = blockIdx.y, frame = blockIdx.z, t = threadIdx.x;
  const int yb0 = blockIdx.x * ybins, nyb = min(ybins, o - yb0);
  const int* bd = bounds + (static_cast<size_t>(frame) * k + box) * 4;
  const int x0 = bd[0], y0 = bd[1], x1 = bd[2], y1 = bd[3];
  for (int i = t; i < o; i += kThreads) xt[i] = bin_edges(i, x0, x1, o);
  if (t < nyb) yt[t] = bin_edges(yb0 + t, y0, y1, o);
  __syncthreads();

  // Columns read: the crop's part inside the frame, as bytes [lo, hi) of
  // a row; chunks of 16 bytes from a0.
  const int cx0 = min(max(x0, 0), w), cx1 = x1 > x0 ? min(max(x1, cx0), w) : cx0;
  const int lo = 3 * cx0, hi = 3 * cx1;
  const int a0 = kVec ? lo & ~15 : lo;
  const int nch = hi > lo && y1 > y0 ? (hi - a0 + 15) >> 4 : 0;
  const int span = nch * 16;
  const int batch = nch > 0 ? min(nyb, cap / span) : nyb;  // y-bins per pass
  const size_t row_bytes = static_cast<size_t>(w) * 3;
  const uint8_t* src = frames + static_cast<size_t>(frame) * h * row_bytes + a0;
  float* dst = out + ((static_cast<size_t>(frame) * k + box) * o + yb0) * o * 3;

  for (int yb = 0; yb < nyb; yb += batch) {
    const int nb = min(batch, nyb - yb);
    for (int u = t; u < nb * nch; u += kThreads) {
      const int yl = u / nch, c = u - yl * nch;
      const int2 ey = yt[yb + yl];
      const int ry0 = max(ey.x, 0), ry1 = min(ey.y, h);
      int acc[16];
#pragma unroll
      for (int b = 0; b < 16; ++b) acc[b] = 0;
      const uint8_t* p = src + static_cast<size_t>(max(ry0, 0)) * row_bytes + 16 * c;
      for (int y = ry0; y < ry1; y += kRows, p += kRows * row_bytes) {
        uint4 v[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          v[r] = y + r < ry1 ? load16<kVec>(p + r * row_bytes, a0 + 16 * c, lo, hi)
                             : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int r = 0; r < kRows; ++r) add_bytes(acc, v[r]);
      }
      int* s = sums + yl * span + c;
#pragma unroll
      for (int b = 0; b < 16; ++b) s[b * nch] = acc[b];
    }
    __syncthreads();

    const int row_len = o * 3;
    for (int e = t; e < nb * row_len; e += kThreads) {
      const int yl = e / row_len, r = e - yl * row_len;
      const int xb = r / 3, ch = r - 3 * xb;
      const int2 ex = xt[xb], ey = yt[yb + yl];
      const int area = (ey.y - ey.x) * (ex.y - ex.x);
      int sum = 0;
      if (nch > 0) {
        const int* s = sums + yl * span;
        const int xe = min(ex.y, cx1);
        for (int x = max(ex.x, cx0); x < xe; ++x) {
          const int pos = 3 * x + ch - a0;
          sum += s[(pos & 15) * nch + (pos >> 4)];
        }
      }
      dst[(yb + yl) * row_len + r] =
          area > 0 ? static_cast<float>(sum) / fmaxf(static_cast<float>(area), 1.0f) : 0.0f;
    }
    __syncthreads();
  }
}

}  // namespace

// frames (n, h, w, 3) u8; bounds (n, k, 4) int32 half-open (x0, y0, x1, y1),
// parts outside the frame read as nothing; out (n, k, o, o, 3) f32.
// 1 <= o <= 256; `ybins` y-bins per CTA, 1..8.
extern "C" int tt_crop_area_fused(const void* frames, const void* bounds, void* out, int n,
                                  int h, int w, int k, int o, int ybins, void* stream) {
  if (o < 1 || o > kMaxO || ybins < 1 || ybins > kMaxYBins)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || k <= 0) return 0;
  const bool vec = (reinterpret_cast<uintptr_t>(frames) & 15) == 0 && (3 * w) % 16 == 0;
  const int cap = max(kSumInts, 16 * ((3 * w + 15) / 16));  // one y-bin of the widest crop
  const size_t smem = static_cast<size_t>(cap) * sizeof(int);
  void (*kernel)(const uint8_t*, const int*, float*, int, int, int, int, int, int) =
      vec ? crop_area_fused_kernel<true> : crop_area_fused_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((o + ybins - 1) / ybins, k, n);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const int*>(bounds),
      static_cast<float*>(out), h, w, k, o, ybins, cap);
  return static_cast<int>(cudaGetLastError());
}
