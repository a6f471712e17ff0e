// K5: exact adaptive-pool ("area") crop-resize of K boxes per frame from
// planar frames, the R-Net (O=24) and O-Net (O=48) stage crops on the
// exact crop chain (use_fused_crops=1, q=1).
//
// Replaces the Pallas kernel truely_tpu/ops/crop_area_fused.py:
// crop_resize_area_fused (_crop_kernel, prep prep_frames_for_fused_crops).
// The TPU kernel shifts the frame to int8, splits column sums into bf16
// hi/lo halves and computes all (k, k') cross-blocks of a second matrix
// product to keep the diagonal, because its matrix unit has no integer
// path.  Its idea, the bin sums held on chip, is kept; the rest is not:
// int32 sums of uint8 are exact on the card.
//
// Design: a CTA owns a group of G consecutive rows of one crop's bins;
// their G x O x C int32 sums live
// in shared memory (at most 27,648 B, at O=48, C=3).  A work item is
// (y-bin, channel, column): its thread sums the column's bytes over the
// y-bin's rows (neighbouring threads read neighbouring bytes of one planar
// row), then adds that sum to every x-bin whose [s, e) holds the column.
// The lanes of a warp that add to one bin are combined first (match +
// reduce), so one shared atomic per bin per warp remains.  Adaptive-pool
// bins overlap by a pixel at non-integer edges, and a crop narrower than O
// puts a pixel in several bins: the x-bins of column x are
// [x*O / L, ((x+1)*O - 1) / L] (x relative to the crop, L its width), and
// a y-bin reads its rows [s, e) whatever other bins hold them.  Then one
// IEEE float32 division per bin, (float)sum / max((float)area, 1), the
// reference's order; empty bins give zeros.  Reads stay inside the frame
// (the sum covers the bin's part inside it, as the plain version's clamped
// integral gathers do); clipped bounds are inside anyway.
//
// G follows the crop's width: the smallest G whose items reach kMinItems
// (8 per thread), so a wide crop spreads over up to O CTAs and a narrow one
// stays in one.  With one CTA per crop, the largest crop (800 px at 1080p:
// 57,600 items of 33 rows) would hold the launch's tail for its 256
// threads alone, and a refine step has only B*4 crops to fill 132 SMs.
//
// Bound on the H100 by bytes: each crop pixel is read from memory once per
// y-bin that holds its row (once, plus the shared edge rows); crops that
// overlap re-read their common pixels, mostly from L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinItems = 2048;  // the least work items of a CTA

__global__ void crop_area_fused_kernel(const uint8_t* __restrict__ frames,
                                       const int* __restrict__ bounds,
                                       float* __restrict__ out, int c, int h,
                                       int w, int k, int o) {
  extern __shared__ int acc[];  // (rows, o, c) bin sums of this CTA's y-bins
  const int box = blockIdx.y, frame = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int* bd = bounds + (static_cast<size_t>(frame) * k + box) * 4;
  const int x0 = bd[0], y0 = bd[1], x1 = bd[2], y1 = bd[3];
  const int lx = max(x1 - x0, 0), ly = max(y1 - y0, 0);
  // Columns read: the crop's part inside the frame.
  const int cx0 = max(x0, 0), cx1 = lx > 0 ? min(x1, w) : cx0;
  const int ncol = max(cx1 - cx0, 0);
  // This CTA's y-bins [oy0, oy0 + rows), g rows per group.
  const int per_row = c * max(ncol, 1);
  const int g = min(max(ceil_div(kMinItems, per_row), 1), o);
  const int oy0 = blockIdx.x * g;
  if (oy0 >= o) return;  // the crop needs fewer groups than the grid has
  const int rows = min(g, o - oy0);
  const int tile = rows * o * c;
  for (int i = tid; i < tile; i += kThreads) acc[i] = 0;
  __syncthreads();

  const int items = ly > 0 ? rows * c * ncol : 0;  // uniform over the CTA
  const uint8_t* planes = frames + static_cast<size_t>(frame) * c * h * w;
  for (int base = 0; base < items; base += kThreads) {
    const int t = base + tid;
    int lo = 1, hi = 0, key0 = 0, sum = 0;
    if (t < items) {
      const int col = t % ncol, rest = t / ncol;
      const int ch = rest % c, r = rest / c, oy = oy0 + r;
      const int x = cx0 + col;
      const int sy = y0 + (oy * ly) / o;
      const int ey = max(y0 + ceil_div((oy + 1) * ly, o), sy);
      const int ry0 = max(sy, 0), ry1 = min(ey, h);
      const uint8_t* p = planes + (static_cast<size_t>(ch) * h + ry0) * w + x;
#pragma unroll 4
      for (int y = ry0; y < ry1; ++y, p += w) sum += *p;
      const int xr = x - x0;
      lo = (xr * o) / lx;
      hi = ((xr + 1) * o - 1) / lx;
      key0 = r * o * c + ch;
    }
    // Add the column sum to x-bins lo..hi, one atomic per bin per warp.
    for (int j = 0; __any_sync(0xffffffffu, lo + j <= hi); ++j) {
      const bool add = lo + j <= hi;
      const int key = add ? key0 + (lo + j) * c : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      const int total = __reduce_add_sync(peers, add ? sum : 0);
      if (add && __ffs(peers) - 1 == lane) atomicAdd(&acc[key], total);
    }
  }
  __syncthreads();

  float* dst = out + ((static_cast<size_t>(frame) * k + box) * o + oy0) * o * c;
  for (int i = tid; i < tile; i += kThreads) {
    const int bin = i / c, oy = oy0 + bin / o, ox = bin % o;
    const int sy = y0 + (oy * ly) / o;
    const int ey = max(y0 + ceil_div((oy + 1) * ly, o), sy);
    const int sx = x0 + (ox * lx) / o;
    const int ex = max(x0 + ceil_div((ox + 1) * lx, o), sx);
    const int area = (ey - sy) * (ex - sx);
    dst[i] = area > 0 ? static_cast<float>(acc[i]) /
                            fmaxf(static_cast<float>(area), 1.0f)
                      : 0.0f;
  }
}

}  // namespace

// frames (n, c, h, w) u8 planar; bounds (n, k, 4) int32 half-open
// (x0, y0, x1, y1) clipped to the frame; out (n, k, o, o, c) f32.
// The o x o x c tile must fit in 48 KB of shared memory (the wrapper
// checks).
extern "C" int tt_crop_area_fused(const void* frames, const void* bounds,
                                  void* out, int n, int c, int h, int w,
                                  int k, int o, void* stream) {
  const int smem = o * o * c * static_cast<int>(sizeof(int));
  dim3 grid(o, k, n);  // groups past a crop's last one exit at once
  crop_area_fused_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const int*>(bounds),
      static_cast<float*>(out), c, h, w, k, o);
  return static_cast<int>(cudaGetLastError());
}
