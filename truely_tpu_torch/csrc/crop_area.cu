// K3: exact adaptive-pool ("area") crop-resize of K boxes per frame, the
// R-Net (O=24) and O-Net (O=48) stage crops.
//
// Replaces the Pallas kernel truely_tpu/ops/crop_fused2.py:
// crop_resize_area_fused2 (_kernel, prep prep_frames_fused2).  quant == 1 is
// that kernel's function, truely_tpu/ops/resize.py:crop_resize_area;
// quant > 1 is crop_resize_area_mxu_quant: the box snaps to the quant-px
// grid (floor near edge, ceil far edge, an empty box stays empty), the bins
// are cut on the grid of quant x quant blocks, and each bin's sum is divided
// by max(area, 1) * quant^2.  A bin over whole blocks is a bin over their
// pixels, so both cases sum pixels straight from the uint8 frame and no
// block-sum pre-pass is needed.
//
// Every bin sum is an exact int32 and the result is one IEEE f32 division
// in the order of the reference, (float)sum / (max((float)area, 1) * q*q),
// so it is bit-equal with it; the TPU kernel's bf16 hi/lo split existed only
// because its matrix unit has no integer path at this width.
//
// Bound on the H100 by bytes: each box's pixels are read once per output
// bin that covers them.  One thread per output bin, three channels, one
// block column of threads per (box, frame); boxes of one frame run side by
// side, so their overlapping reads hit L2.
#include "common.cuh"

namespace {

__global__ void crop_area_kernel(const uint8_t* __restrict__ frames,
                                 const int* __restrict__ bounds,
                                 float* __restrict__ out, int h, int w, int k,
                                 int o, int quant) {
  const int bin = blockIdx.x * blockDim.x + threadIdx.x;
  if (bin >= o * o) return;
  const int oy = bin / o, ox = bin % o;
  const int box = blockIdx.y, frame = blockIdx.z;
  const int* bd = bounds + (static_cast<size_t>(frame) * k + box) * 4;
  int x0 = bd[0], y0 = bd[1], x1 = bd[2], y1 = bd[3];
  if (quant > 1) {
    const int qx0 = floor_div(x0, quant), qy0 = floor_div(y0, quant);
    x1 = x1 > x0 ? ceil_div(x1, quant) : qx0;
    y1 = y1 > y0 ? ceil_div(y1, quant) : qy0;
    x0 = qx0;
    y0 = qy0;
  }
  // Adaptive-pool bin edges: [start + floor(i*len/o), start + ceil((i+1)*len/o)).
  const int lx = max(x1 - x0, 0), ly = max(y1 - y0, 0);
  const int sx = x0 + (ox * lx) / o;
  const int ex = max(x0 + ceil_div((ox + 1) * lx, o), sx);
  const int sy = y0 + (oy * ly) / o;
  const int ey = max(y0 + ceil_div((oy + 1) * ly, o), sy);
  const int area = (ey - sy) * (ex - sx);
  float* dst = out + ((static_cast<size_t>(frame) * k + box) * o * o + bin) * 3;
  if (area <= 0) {  // empty bin (boxes outside the frame land here too)
    dst[0] = dst[1] = dst[2] = 0.0f;
    return;
  }

  // Pixel rectangle of the bin, kept inside the frame for memory safety
  // (a nonempty bin of clipped bounds is inside already).
  const int px0 = max(sx * quant, 0), px1 = min(ex * quant, w);
  const int py0 = max(sy * quant, 0), py1 = min(ey * quant, h);
  const uint8_t* src = frames + static_cast<size_t>(frame) * h * w * 3;
  int s0 = 0, s1 = 0, s2 = 0;
  for (int y = py0; y < py1; ++y) {
    const uint8_t* p = src + (static_cast<size_t>(y) * w + px0) * 3;
    for (int x = px0; x < px1; ++x, p += 3) {
      s0 += p[0];
      s1 += p[1];
      s2 += p[2];
    }
  }
  const float denom = fmaxf(static_cast<float>(area), 1.0f) *
                      static_cast<float>(quant * quant);
  dst[0] = static_cast<float>(s0) / denom;
  dst[1] = static_cast<float>(s1) / denom;
  dst[2] = static_cast<float>(s2) / denom;
}

}  // namespace

// frames (n, h, w, 3) u8; bounds (n, k, 4) int32 half-open (x0, y0, x1, y1)
// clipped to the frame; out (n, k, o, o, 3) f32.  With quant > 1, h and w
// are multiples of quant.
extern "C" int tt_crop_area(const void* frames, const void* bounds, void* out,
                            int n, int h, int w, int k, int o, int quant,
                            void* stream) {
  const int threads = 128;
  dim3 grid((o * o + threads - 1) / threads, k, n);
  crop_area_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const int*>(bounds),
      static_cast<float*>(out), h, w, k, o, quant);
  return static_cast<int>(cudaGetLastError());
}
