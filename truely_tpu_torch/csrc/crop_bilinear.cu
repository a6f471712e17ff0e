// K4: cv2 INTER_LINEAR crop-resize of one box per frame, the 80x80 face
// crop fed to FaceNet and the landmark head.
//
// Replaces the Pallas kernel truely_tpu/ops/crop_pallas.py:
// crop_resize_bilinear_pallas (_crop_kernel), computing the function of the
// default XLA path truely_tpu/ops/resize.py:_crop_bilinear_one: half-pixel
// centres inside the crop, sample coordinates clamped to the crop, source
// indices clamped to the frame, an empty box gives zeros, and the lerps
// associate as t + (b - t) * f (the Pallas kernel's t*(1-f) + b*f rounds
// differently).  Every f32 operation is written in the reference's order
// and the file is built with -fmad=false, so no product fuses into an FMA:
// the result is bit-equal with the plain version.
//
// Bound on the H100 by bytes, and tiny (2.5 MB of f32 out at B=32, O=80,
// bound 0.001 ms): its device time, about 3 us, is latency, and a call
// costs the host several times that (see ops/cuda_build.py:launch).  One
// thread per output pixel, three channels, each thread computing its own
// sample coordinates: on NVIDIA H100 80GB HBM3, 700.00 W, this read 0.0031
// ms of device time where a CTA per box band that first computes the band's
// coordinate tables into shared memory read 0.0035-0.0037 ms (chip_smoke.py
// --kernels-only in one call): the tables' barrier lengthens the latency
// chain more than the per-pixel divisions cost.
#include "common.cuh"

namespace {

__device__ __forceinline__ float sample_coord(int i, float len, float o) {
  // clip((i + 0.5) * len / o - 0.5, 0, max(len - 1, 0))
  const float s = (static_cast<float>(i) + 0.5f) * len / o - 0.5f;
  return fminf(fmaxf(s, 0.0f), fmaxf(len - 1.0f, 0.0f));
}

__global__ void crop_bilinear_kernel(const uint8_t* __restrict__ frames,
                                     const int* __restrict__ bounds,
                                     float* __restrict__ out, int h, int w,
                                     int k, int o) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= o * o) return;
  const int oy = pix / o, ox = pix % o;
  const int box = blockIdx.y, frame = blockIdx.z;
  const int* bd = bounds + (static_cast<size_t>(frame) * k + box) * 4;
  const int x0 = bd[0], y0 = bd[1], x1 = bd[2], y1 = bd[3];
  float* dst = out + ((static_cast<size_t>(frame) * k + box) * o * o + pix) * 3;
  if (!(y1 > y0 && x1 > x0)) {
    dst[0] = dst[1] = dst[2] = 0.0f;
    return;
  }
  const float fo = static_cast<float>(o);
  const float ay = static_cast<float>(y0) + sample_coord(oy, static_cast<float>(y1 - y0), fo);
  const float ax = static_cast<float>(x0) + sample_coord(ox, static_cast<float>(x1 - x0), fo);
  int ylo = static_cast<int>(floorf(ay));
  int xlo = static_cast<int>(floorf(ax));
  const float fy = ay - static_cast<float>(ylo);
  const float fx = ax - static_cast<float>(xlo);
  const int yhi = min(max(ylo + 1, 0), h - 1);
  const int xhi = min(max(xlo + 1, 0), w - 1);
  ylo = min(max(ylo, 0), h - 1);
  xlo = min(max(xlo, 0), w - 1);

  const uint8_t* src = frames + static_cast<size_t>(frame) * h * w * 3;
  const uint8_t* tl = src + (static_cast<size_t>(ylo) * w + xlo) * 3;
  const uint8_t* tr = src + (static_cast<size_t>(ylo) * w + xhi) * 3;
  const uint8_t* bl = src + (static_cast<size_t>(yhi) * w + xlo) * 3;
  const uint8_t* br = src + (static_cast<size_t>(yhi) * w + xhi) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float vtl = tl[c], vtr = tr[c], vbl = bl[c], vbr = br[c];
    const float top = vtl + (vtr - vtl) * fx;
    const float bot = vbl + (vbr - vbl) * fx;
    dst[c] = top + (bot - top) * fy;
  }
}

}  // namespace

// frames (n, h, w, 3) u8; bounds (n, k, 4) int32 half-open (x0, y0, x1, y1);
// out (n, k, o, o, 3) f32.
extern "C" int tt_crop_bilinear(const void* frames, const void* bounds,
                                void* out, int n, int h, int w, int k, int o,
                                void* stream) {
  const int threads = 128;
  dim3 grid((o * o + threads - 1) / threads, k, n);
  crop_bilinear_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const int*>(bounds),
      static_cast<float*>(out), h, w, k, o);
  return static_cast<int>(cudaGetLastError());
}
