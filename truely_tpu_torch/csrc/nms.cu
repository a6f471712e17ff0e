// K2: masked greedy NMS as a round-parallel fixpoint.
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
// few rounds (2-3 on cascade candidates) of K-word bitmask tests.  What
// costs is latency, so the design spreads the K x K relation build:
//
// - A frame is a cluster of `cl` CTAs (the wrapper takes cl = 2 above
//   K = 64, which read faster than 1, 4 and 8); each builds the rows i of
//   its share of the suppressees.  A warp builds one 32-bit word per step: lane b holds
//   candidate j = 32w + b in registers for the whole build, candidate i
//   is a shared-memory broadcast, and __ballot_sync gives the word.  The
//   warps of a CTA take the words of its rows, then split the rows.
// - The CTAs of a cluster then copy each other's rows through distributed
//   shared memory, so each holds the whole relation (8 KB at K = 256) and
//   runs the rounds on its own: every CTA of a frame computes the same
//   rounds and leaves the loop in the same round, with no cluster barrier
//   per round.  Each writes the keep flags of its own rows.
// - No division: RN(inter / d) > thr is decided exactly as
//   inter > d * m in float64, m the midpoint of thr and the next float up
//   (a 24-bit by 25-bit product is exact in a double), with a tie at m
//   resolved as round-to-nearest-even resolves it (the host passes m and
//   whether the tie rounds up; ops/nms.py:iou_cut).  This needs thr >= 0,
//   which the wrapper checks.
//
// Built with -fmad=false: (area_j + area_i) - ix*iy would otherwise fuse
// into an FMA and change the union denominator in its last bit.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 256;
constexpr int kWords = kMaxK / 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kRowsPerWarp = 8;  // rows a warp builds, before more warps are added

__global__ void __launch_bounds__(kMaxThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           const uint8_t* __restrict__ valid, const int* __restrict__ groups,
           uint8_t* __restrict__ keep, int k, double cut, int tie_up, int use_min,
           int max_rounds, int cl) {
  __shared__ float4 sbox[kMaxK];
  __shared__ float sarea[kMaxK], sscore[kMaxK];
  __shared__ int sgroup[kMaxK];
  __shared__ uint8_t svalid[kMaxK];
  // over[i][w] bit b: candidate j = 32*w + b suppresses i if j is kept.
  __shared__ __align__(16) uint32_t over[kMaxK][kWords];
  __shared__ uint32_t flags_w[2][kWords];  // two buffers: a round needs no barrier between them

  const int t = threadIdx.x, nthreads = blockDim.x;
  const int lane = t & 31, warp = t >> 5;
  const int frame = blockIdx.x / cl, rank = blockIdx.x - frame * cl;
  const size_t base = static_cast<size_t>(frame) * k;
  for (int i = t; i < k; i += nthreads) {
    const float4 bx = reinterpret_cast<const float4*>(boxes)[base + i];
    sbox[i] = bx;
    sarea[i] = (bx.z - bx.x + 1.0f) * (bx.w - bx.y + 1.0f);
    sscore[i] = scores[base + i];
    sgroup[i] = groups ? groups[base + i] : 0;
    svalid[i] = valid[base + i];
  }
  __syncthreads();

  // Build this CTA's rows [r0, r1): warp -> (word, row group).
  const int nwords = (k + 31) / 32;
  const int rows = (k + cl - 1) / cl;
  const int r0 = rank * rows, r1 = min(k, r0 + rows);
  const int ngroups = (nthreads >> 5) / nwords;
  const int word = warp % nwords, group = warp / nwords;
  if (group < ngroups) {
    const int j = word * 32 + lane;
    const bool jvalid = j < k && svalid[j];
    const float4 bj = jvalid ? sbox[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float aj = jvalid ? sarea[j] : 0.0f, sj = jvalid ? sscore[j] : 0.0f;
    const int gj = jvalid ? sgroup[j] : 0;
    for (int i = r0 + group; i < r1; i += ngroups) {
      const float4 bi = sbox[i];
      const float ai = sarea[i], si = sscore[i];
      bool hit = false;
      if (jvalid && gj == sgroup[i] && (sj > si || (sj == si && j < i))) {
        const float ix = fmaxf(0.0f, fminf(bj.z, bi.z) - fmaxf(bj.x, bi.x) + 1.0f);
        const float iy = fmaxf(0.0f, fminf(bj.w, bi.w) - fmaxf(bj.y, bi.y) + 1.0f);
        const float inter = ix * iy;
        const float denom = use_min ? fminf(aj, ai) : aj + ai - inter;
        const double dm = static_cast<double>(fmaxf(denom, 1e-12f)) * cut;
        const double in = static_cast<double>(inter);
        hit = in > dm || (tie_up && in == dm);
      }
      const uint32_t bits = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) over[i][word] = bits;
    }
  }

  if (cl > 1) {  // gather the other CTAs' rows
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int p = 0; p < cl; ++p) {
      const int p0 = p * rows, p1 = min(k, p0 + rows);
      if (p == rank || p1 <= p0) continue;
      const uint4* peer = reinterpret_cast<const uint4*>(cluster.map_shared_rank(&over[p0][0], p));
      uint4* mine = reinterpret_cast<uint4*>(&over[p0][0]);
      for (int e = t; e < (p1 - p0) * (kWords / 4); e += nthreads) mine[e] = peer[e];
    }
    cluster.sync();  // no CTA leaves while another still reads its rows
  } else {
    __syncthreads();
  }

  uint32_t row[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) row[w] = (t < k && w < nwords) ? over[t][w] : 0u;
  auto hits = [&](int buf) {
    uint32_t any = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) any |= row[w] & flags_w[buf][w];
    return any != 0;
  };
  // Warps past the last word publish nothing (flags_w has kWords entries;
  // their candidates t >= k are decided).
  auto publish = [&](int buf, bool flag) {
    const uint32_t bits = __ballot_sync(0xffffffffu, flag);
    if (lane == 0 && warp < kWords) flags_w[buf][warp] = warp < nwords ? bits : 0u;
  };

  bool kept = false;
  bool suppressed = !(t < k && svalid[t]);  // invalid slots are decided
  for (int r = 0;; ++r) {
    const bool undecided = !(kept || suppressed);
    if (!__syncthreads_or(undecided) || (max_rounds > 0 && r >= max_rounds)) break;
    // Blocked: some overlapping higher-ranked j is kept or undecided.
    // Buffer 0, then buffer 1: each is written only after the barrier
    // that follows the last reads of it.
    publish(0, kept || undecided);
    __syncthreads();
    kept = kept || (undecided && !hits(0));
    publish(1, kept);
    __syncthreads();
    suppressed = suppressed || (undecided && hits(1));
  }
  if (max_rounds > 0) {
    const bool undecided = !(kept || suppressed);
    publish(0, kept);  // the loop's exit barrier follows the last reads of buffer 0
    __syncthreads();
    kept = kept || (undecided && !hits(0));
  }
  if (t >= r0 && t < r1) keep[base + t] = kept ? 1 : 0;
}

}  // namespace

// boxes (n, k, 4) f32, 16-byte aligned; scores (n, k) f32; valid (n, k) u8;
// groups (n, k) int32 or null; keep (n, k) u8.  1 <= k <= 256; `cut` and
// `tie_up` from ops/nms.py:iou_cut; `cluster` CTAs per frame, 1..8.
extern "C" int tt_nms(const void* boxes, const void* scores, const void* valid,
                      const void* groups, void* keep, int n, int k, double cut, int tie_up,
                      int use_min, int max_rounds, int cluster, void* stream) {
  if (k > kMaxK || k < 1 || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int nwords = (k + 31) / 32;
  const int rows = (k + cluster - 1) / cluster;
  const int ngroups = max(1, min((rows + kRowsPerWarp - 1) / kRowsPerWarp,
                                 kMaxThreads / (32 * nwords)));
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n * cluster);
  config.blockDim = dim3(32 * nwords * ngroups);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, nms_kernel, static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(groups),
      static_cast<uint8_t*>(keep), k, cut, tie_up, use_min, max_rounds, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
