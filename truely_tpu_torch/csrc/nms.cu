// K2: masked greedy NMS as a round-parallel fixpoint, one CTA per frame.
//
// Replaces the Pallas kernel truely_tpu/ops/nms_pallas.py:
// nms_masked_batch_pallas (_nms_kernel), and also takes the per-candidate
// `groups` that the Pallas kernel refuses, so all four cascade NMS calls
// run here.  Semantics are those of truely_tpu/ops/nms.py:nms_masked_batch:
// IoU with the +1 pixel convention ('union' or 'min' denominator), j
// outranks i by a higher score or an equal score and a lower index, and in
// every round each undecided candidate whose overlapping higher-ranked
// candidates are all suppressed is kept, then every undecided candidate
// overlapped by a kept one is suppressed.  With max_rounds > 0 the loop
// stops after that many rounds and the tail rule keeps every undecided
// candidate that no kept one overlaps.
//
// Bound on the H100 by operations, and tiny: K*K IoU tests per frame and a
// few rounds of K-word bitmask tests.  The K x K overlap relation lives in
// shared memory as bits (8 KB at K=256), so the rounds never leave the SM.
// Built with -fmad=false: (area_j + area_i) - ix*iy would otherwise fuse
// into an FMA and change the IoU in its last bit.
#include "common.cuh"

namespace {

constexpr int kMaxK = 256;
constexpr int kWords = kMaxK / 32;

__global__ void __launch_bounds__(kMaxK)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           const uint8_t* __restrict__ valid, const int* __restrict__ groups,
           uint8_t* __restrict__ keep, int k, float thr, int use_min,
           int max_rounds) {
  __shared__ float sx1[kMaxK], sy1[kMaxK], sx2[kMaxK], sy2[kMaxK];
  __shared__ float sarea[kMaxK], sscore[kMaxK];
  __shared__ int sgroup[kMaxK];
  __shared__ uint8_t svalid[kMaxK];
  // over[i][w] bit b: candidate j = 32*w + b suppresses i if j is kept.
  __shared__ uint32_t over[kMaxK][kWords];
  __shared__ uint32_t flags_w[kWords];

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  if (t < k) {
    const float* bx = boxes + (base + t) * 4;
    sx1[t] = bx[0];
    sy1[t] = bx[1];
    sx2[t] = bx[2];
    sy2[t] = bx[3];
    sarea[t] = (bx[2] - bx[0] + 1.0f) * (bx[3] - bx[1] + 1.0f);
    sscore[t] = scores[base + t];
    sgroup[t] = groups ? groups[base + t] : 0;
    svalid[t] = valid[base + t];
  }
  __syncthreads();

  const int nwords = (k + 31) / 32;
  if (t < k) {
    const float x1 = sx1[t], y1 = sy1[t], x2 = sx2[t], y2 = sy2[t];
    const float area = sarea[t], score = sscore[t];
    const int group = sgroup[t];
    for (int w = 0; w < nwords; ++w) {
      uint32_t word = 0;
      for (int b = 0; b < 32; ++b) {
        const int j = w * 32 + b;
        if (j >= k || !svalid[j] || sgroup[j] != group) continue;
        const bool outranks =
            sscore[j] > score || (sscore[j] == score && j < t);
        if (!outranks) continue;
        const float ix = fmaxf(0.0f, fminf(sx2[j], x2) - fmaxf(sx1[j], x1) + 1.0f);
        const float iy = fmaxf(0.0f, fminf(sy2[j], y2) - fmaxf(sy1[j], y1) + 1.0f);
        const float inter = ix * iy;
        const float denom = use_min ? fminf(sarea[j], area) : sarea[j] + area - inter;
        if (inter / fmaxf(denom, 1e-12f) > thr) word |= 1u << b;
      }
      over[t][w] = word;
    }
  }

  bool kept = false;
  bool suppressed = !(t < k && svalid[t]);  // invalid slots are decided
  for (int r = 0;; ++r) {
    const bool undecided = !(kept || suppressed);
    if (!__syncthreads_or(undecided) || (max_rounds > 0 && r >= max_rounds)) break;
    // Blocked: some overlapping higher-ranked j is kept or undecided.
    uint32_t bits = __ballot_sync(0xffffffffu, kept || undecided);
    if (lane == 0) flags_w[warp] = bits;
    __syncthreads();
    bool blocked = false;
    for (int w = 0; w < nwords; ++w) blocked |= (t < k) && (over[t][w] & flags_w[w]);
    kept = kept || (undecided && !blocked);
    __syncthreads();
    bits = __ballot_sync(0xffffffffu, kept);
    if (lane == 0) flags_w[warp] = bits;
    __syncthreads();
    bool dead = false;
    for (int w = 0; w < nwords; ++w) dead |= (t < k) && (over[t][w] & flags_w[w]);
    suppressed = suppressed || (undecided && dead);
  }
  if (max_rounds > 0) {
    const bool undecided = !(kept || suppressed);
    const uint32_t bits = __ballot_sync(0xffffffffu, kept);
    __syncthreads();
    if (lane == 0) flags_w[warp] = bits;
    __syncthreads();
    bool dead = false;
    for (int w = 0; w < nwords; ++w) dead |= (t < k) && (over[t][w] & flags_w[w]);
    kept = kept || (undecided && !dead);
  }
  if (t < k) keep[base + t] = kept ? 1 : 0;
}

}  // namespace

// boxes (n, k, 4) f32; scores (n, k) f32; valid (n, k) u8; groups (n, k)
// int32 or null; keep (n, k) u8.  k <= 256.
extern "C" int tt_nms(const void* boxes, const void* scores, const void* valid,
                      const void* groups, void* keep, int n, int k, float thr,
                      int use_min, int max_rounds, void* stream) {
  if (k > kMaxK || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  nms_kernel<<<n, kMaxK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(groups),
      static_cast<uint8_t*>(keep), k, thr, use_min, max_rounds);
  return static_cast<int>(cudaGetLastError());
}
