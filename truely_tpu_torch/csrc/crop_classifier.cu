// K7: the DFDC winner's classifier crop (kernel_utils.py of
// github.com/selimsef/dfdc_deepfake_challenge) for every (frame, track) slot
// of a batch in one launch: the detector's box truncated to integers, grown
// by a third (w // margin, h // margin) on each side and clipped as numpy
// slices clip, resized isotropically so that its long side is `size` (cv2
// INTER_AREA when shrinking, INTER_CUBIC when growing, a copy when the long
// side is already `size`), rounded to uint8, centred on a zero size x size
// canvas, and normalised through a (256, 3) bf16 table of
// (v / 255 - mean) / std in RGB order.  Masked slots are zeros.
//
// Replaces no TPU kernel: the JAX package has no classifier.  The plain
// version is ops/crop_classifier.py:crop_classifier_plain; the resampling
// is exact integer arithmetic (area: the exact mean of the covered source
// area, the overlaps integers once coordinates are scaled by the output
// length, rounded half up; cubic: cv2's fixed-point coefficients, shorts
// of scale 2048 from float32 interpolateCubic, integer sums), so the two
// agree bit for bit.  The geometry is computed in double and float exactly
// as the plain version computes it; built with -fmad=false, nothing fuses.
//
// Bound by bytes: each slot writes size * size * 3 bf16 values (0.87 MB
// at 380) and reads its source rectangle.  One thread per output pixel,
// its three channels; each thread works out its slot's geometry (a few
// integer and double operations) and its own taps, and reads the frame
// through the cache: the rectangle's rows are read by the neighbouring
// threads of a warp.
#include "common.cuh"

namespace {

struct Geometry {
  int y0, x0, ch, cw, nh, nw, oy, ox;
};

// numpy's [lo:hi] of a length-n axis, lo >= 0: (start, length).
__device__ __forceinline__ void clip_slice(int lo, int hi, int n, int* start, int* len) {
  if (hi < 0) hi += n;
  const int s = min(lo, n);
  const int e = min(max(hi, 0), n);
  *start = s;
  *len = e - s;
}

__device__ bool geometry(const float* box, int h, int w, int size, int margin, Geometry* g) {
  const int xmin = static_cast<int>(box[0]), ymin = static_cast<int>(box[1]);
  const int xmax = static_cast<int>(box[2]), ymax = static_cast<int>(box[3]);
  const int p_w = floor_div(xmax - xmin, margin), p_h = floor_div(ymax - ymin, margin);
  clip_slice(max(ymin - p_h, 0), ymax + p_h, h, &g->y0, &g->ch);
  clip_slice(max(xmin - p_w, 0), xmax + p_w, w, &g->x0, &g->cw);
  if (g->ch <= 0 || g->cw <= 0) return false;
  if (max(g->ch, g->cw) == size) {
    g->nh = g->ch;
    g->nw = g->cw;
  } else if (g->cw > g->ch) {
    g->nh = static_cast<int>(static_cast<double>(g->ch) *
                             (static_cast<double>(size) / static_cast<double>(g->cw)));
    g->nw = size;
  } else {
    g->nh = size;
    g->nw = static_cast<int>(static_cast<double>(g->cw) *
                             (static_cast<double>(size) / static_cast<double>(g->ch)));
  }
  g->nh = max(g->nh, 1);
  g->nw = max(g->nw, 1);
  g->oy = (size - g->nh) / 2;
  g->ox = (size - g->nw) / 2;
  return true;
}

// cv2's fixed-point cubic taps of output j along an axis of src -> dst:
// first tap index (before clamping) and four coefficients of scale 2048.
__device__ void cubic_taps(int j, int src, int dst, int* first, int coef[4]) {
  const double scale = 1.0 / (static_cast<double>(dst) / static_cast<double>(src));
  float fx = static_cast<float>((static_cast<double>(j) + 0.5) * scale - 0.5);
  const int sx = static_cast<int>(floorf(fx));
  fx = fx - static_cast<float>(sx);
  const float a = -0.75f;
  const float x1 = fx + 1.0f;
  const float c0 = ((a * x1 - 5.0f * a) * x1 + 8.0f * a) * x1 - 4.0f * a;
  const float c1 = ((a + 2.0f) * fx - (a + 3.0f)) * fx * fx + 1.0f;
  const float y = 1.0f - fx;
  const float c2 = ((a + 2.0f) * y - (a + 3.0f)) * y * y + 1.0f;
  const float c3 = 1.0f - c0 - c1 - c2;
  coef[0] = __float2int_rn(c0 * 2048.0f);
  coef[1] = __float2int_rn(c1 * 2048.0f);
  coef[2] = __float2int_rn(c2 * 2048.0f);
  coef[3] = __float2int_rn(c3 * 2048.0f);
  *first = sx - 1;
}

__global__ void crop_classifier_kernel(const uint8_t* __restrict__ frames,
                                       const float* __restrict__ boxes,
                                       const uint8_t* __restrict__ mask,
                                       const uint16_t* __restrict__ table,
                                       uint16_t* __restrict__ out, int h, int w, int t,
                                       int size, int margin, int rgb_in) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= size * size) return;
  const int slot = blockIdx.y;
  uint16_t* dst = out + (static_cast<size_t>(slot) * size * size + pix) * 3;
  Geometry g;
  if (!mask[slot] || !geometry(boxes + static_cast<size_t>(slot) * 4, h, w, size, margin, &g)) {
    dst[0] = dst[1] = dst[2] = 0;
    return;
  }
  const int ry = pix / size - g.oy, rx = pix % size - g.ox;
  int v[3] = {0, 0, 0};  // the canvas's bytes, in the frame's channel order
  if (ry >= 0 && ry < g.nh && rx >= 0 && rx < g.nw) {
    const uint8_t* src = frames + static_cast<size_t>(slot / t) * h * w * 3;
    if (max(g.ch, g.cw) == size) {
      const uint8_t* p = src + (static_cast<size_t>(g.y0 + ry) * w + g.x0 + rx) * 3;
      v[0] = p[0];
      v[1] = p[1];
      v[2] = p[2];
    } else if (max(g.ch, g.cw) > size) {
      // Area: output (ry, rx) covers [ry*ch, (ry+1)*ch) x [rx*cw, (rx+1)*cw)
      // in units of 1/nh, 1/nw of a source pixel.
      const long long ch = g.ch, cw = g.cw, nh = g.nh, nw = g.nw, oy = ry, ox = rx;
      long long num[3] = {0, 0, 0};
      const int ylo = static_cast<int>(oy * ch / nh);
      const int yhi = static_cast<int>(((oy + 1) * ch + nh - 1) / nh);
      const int xlo = static_cast<int>(ox * cw / nw);
      const int xhi = static_cast<int>(((ox + 1) * cw + nw - 1) / nw);
      for (int i = ylo; i < yhi; ++i) {
        const long long wy = min((i + 1) * nh, (oy + 1) * ch) - max(i * nh, oy * ch);
        if (wy <= 0) continue;
        const uint8_t* row = src + (static_cast<size_t>(g.y0 + i) * w + g.x0) * 3;
        long long acc[3] = {0, 0, 0};
        for (int k = xlo; k < xhi; ++k) {
          const long long wx = min((k + 1) * nw, (ox + 1) * cw) - max(k * nw, ox * cw);
          if (wx <= 0) continue;
          acc[0] += wx * row[k * 3];
          acc[1] += wx * row[k * 3 + 1];
          acc[2] += wx * row[k * 3 + 2];
        }
        num[0] += wy * acc[0];
        num[1] += wy * acc[1];
        num[2] += wy * acc[2];
      }
      const long long den = ch * cw;
      for (int c = 0; c < 3; ++c) v[c] = min(static_cast<int>((2 * num[c] + den) / (2 * den)), 255);
    } else {
      // Cubic: four taps an axis, clamped to the edge; horizontal sums,
      // then the vertical sum, (s + 2^21) >> 22.
      int fy, fx, cy[4], cx[4];
      cubic_taps(ry, g.ch, g.nh, &fy, cy);
      cubic_taps(rx, g.cw, g.nw, &fx, cx);
      long long s[3] = {0, 0, 0};
      for (int a = 0; a < 4; ++a) {
        const int sy = min(max(fy + a, 0), g.ch - 1);
        const uint8_t* row = src + (static_cast<size_t>(g.y0 + sy) * w + g.x0) * 3;
        long long r[3] = {0, 0, 0};
        for (int b = 0; b < 4; ++b) {
          const int sx = min(max(fx + b, 0), g.cw - 1);
          r[0] += static_cast<long long>(cx[b]) * row[sx * 3];
          r[1] += static_cast<long long>(cx[b]) * row[sx * 3 + 1];
          r[2] += static_cast<long long>(cx[b]) * row[sx * 3 + 2];
        }
        s[0] += cy[a] * r[0];
        s[1] += cy[a] * r[1];
        s[2] += cy[a] * r[2];
      }
      for (int c = 0; c < 3; ++c) {
        const long long q = (s[c] + (1LL << 21)) >> 22;  // arithmetic: a floor
        v[c] = static_cast<int>(q < 0 ? 0 : (q > 255 ? 255 : q));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) dst[c] = table[v[rgb_in ? c : 2 - c] * 3 + c];
}

}  // namespace

// frames (n, h, w, 3) u8; boxes (n, t, 4) f32; mask (n, t) u8; table (256, 3)
// bf16; out (n * t, size, size, 3) bf16.
extern "C" int tt_crop_classifier(const void* frames, const void* boxes, const void* mask,
                                  const void* table, void* out, int n, int h, int w, int t,
                                  int size, int margin, int rgb_in, void* stream) {
  if (n * t == 0) return 0;
  const int threads = 256;
  dim3 grid((size * size + threads - 1) / threads, n * t);
  crop_classifier_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const float*>(boxes),
      static_cast<const uint8_t*>(mask), static_cast<const uint16_t*>(table),
      static_cast<uint16_t*>(out), h, w, t, size, margin, rgb_in);
  return static_cast<int>(cudaGetLastError());
}
