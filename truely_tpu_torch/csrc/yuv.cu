// K1: packed I420 -> interleaved BGR (or RGB), the exact cv2/swscale
// BT.601 limited-range fixed-point function.
//
// Replaces the Pallas kernel truely_tpu/ops/yuv.py:i420_to_bgr_pallas
// (_i420_kernel).  Bound on the H100 by bytes: 1.5 bytes read and 3 written
// per pixel, a handful of int32 operations each.  One thread per 2x2 luma
// quad reads its u and v once, computes the three chroma terms once, and
// writes the four interleaved pixels straight into NHWC (the TPU kernel's
// planar output and transpose are a lane-layout matter).
#include "common.cuh"

namespace {

__device__ __forceinline__ uint8_t clip_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

__global__ void i420_to_bgr_kernel(const uint8_t* __restrict__ packed,
                                   uint8_t* __restrict__ out, int h, int w,
                                   int rgb) {
  const int cw = w >> 1, ch = h >> 1;
  const int cx = blockIdx.x * blockDim.x + threadIdx.x;
  const int cy = blockIdx.y;
  if (cx >= cw) return;
  const size_t frame = static_cast<size_t>(blockIdx.z);
  const uint8_t* src = packed + frame * (static_cast<size_t>(h) * 3 / 2) * w;
  uint8_t* dst = out + frame * static_cast<size_t>(h) * w * 3;

  // The U plane follows Y as one contiguous (h/2, w/2) plane, V after it.
  const size_t c = static_cast<size_t>(cy) * cw + cx;
  const int u = src[static_cast<size_t>(h) * w + c];
  const int v = src[static_cast<size_t>(h) * w + static_cast<size_t>(ch) * cw + c];
  // Fixed-point (m, b) with out = (m*x + b) >> 16 (arithmetic shift).
  const int tb = (u * 132193 + -16920704) >> 16;
  const int tg = ((u * -25673 + 3286144) >> 16) + ((v * -53281 + 6819968) >> 16);
  const int tr = (v * 104593 + -13387904) >> 16;
  const int first = rgb ? tr : tb;
  const int last = rgb ? tb : tr;

#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const size_t row = static_cast<size_t>(2 * cy + dy) * w;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const size_t px = row + 2 * cx + dx;
      const int q = (src[px] * 76305 + -1219995) >> 16;
      dst[px * 3 + 0] = clip_u8(q + first);
      dst[px * 3 + 1] = clip_u8(q + tg);
      dst[px * 3 + 2] = clip_u8(q + last);
    }
  }
}

}  // namespace

// packed: (n, 3h/2, w) uint8; out: (n, h, w, 3) uint8.  h % 4 == 0, w even.
extern "C" int tt_i420_to_bgr(const void* packed, void* out, int n, int h,
                              int w, int rgb, void* stream) {
  const int threads = 128;
  dim3 grid((w / 2 + threads - 1) / threads, h / 2, n);
  i420_to_bgr_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<uint8_t*>(out), h, w,
      rgb);
  return static_cast<int>(cudaGetLastError());
}
