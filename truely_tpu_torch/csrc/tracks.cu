// K6: the multi-face track fold of a batch, every frame of every stream, in
// one launch.
//
// Replaces no TPU kernel: the JAX package folds tracks with a lax.scan
// (truely_tpu/pipeline/tracks.py:track_timeline), which XLA runs as one loop
// on the device.  The port's plain version
// (truely_tpu_torch/pipeline/tracks.py:track_timeline_plain) loops over the
// frames in Python, some 180 small ATen launches a frame, so a batch of 32
// frames cost about 5,800 launches and 50-150 ms of host time while the
// card idled.  This kernel computes the same fold in one launch.
//
// Bound by latency, not by bytes or operations: per stream and frame it
// computes T x K IoUs, min(T, K) rounds of an argmax, T dot products of D
// floats and a few integer updates, and each frame depends on the one
// before.  So one CTA folds a stream, its frames in order; streams are
// independent CTAs.  The CTA keeps the stream's state in its slice of the
// output state, which it first copies from the input, and a frame's
// scratch (the score matrix, the match, the spawn order) in its slice of a
// workspace, so no shape is too large for it.  Warp 0 runs the greedy
// match and the per-track rules, a lane per track or detection in chunks
// of 32, with ballots for the spawn ranks; the warps share the dot
// products (a warp per track) and the embedding copies.
//
// Each frame step is track_step's arithmetic in track_step's order, and
// the file is built with -fmad=false, so boxes, embeddings, the discrete
// state and the counters equal the plain version's bit for bit.  The
// similarity's dot product and norms are summed in another order than
// ATen's, so track_sim may differ from the plain version's in its last bits.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

struct StateIn {  // a TrackState of (S, T, ...) tensors
  const uint8_t* active;
  const float* box;
  const float* emb;
  const uint8_t* has_prev;
  const int* counter;
  const int* flagged;
  const int* processed;
  const int* misses;
  const int* final_counter;
};

struct State {  // the output state, which the fold updates in place
  uint8_t* active;
  float* box;
  float* emb;
  uint8_t* has_prev;
  int* counter;
  int* flagged;
  int* processed;
  int* misses;
  int* final_counter;
};

struct FrameOut {  // TrackFrameOut of (S, F, T, ...) tensors
  uint8_t* flagged;
  float* sim;
  float* box;
  uint8_t* active;
  uint8_t* updated;
};

struct Rules {
  float similarity_threshold;
  int run_length_threshold;
  float match_iou;
  int max_misses;
};

// A stream's workspace, in int32 words: the (T, K) score matrix, then per
// track the similarity, the matched detection and the detection whose
// embedding the track takes (or -1), then per detection the matched track
// and the unmatched detections in order.
__host__ __device__ inline size_t workspace_words(int nt, int nk) {
  return static_cast<size_t>(nt) * nk + 3 * static_cast<size_t>(nt) + 2 * static_cast<size_t>(nk);
}

__global__ void __launch_bounds__(32 * kMaxWarps)
track_fold_kernel(StateIn in, const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                  const float* __restrict__ det_emb, const int* __restrict__ n_valid_dev,
                  int n_valid, State st, FrameOut out, int* workspace, int f, int nt, int nk,
                  int d, Rules rules) {
  const int s = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const size_t s0 = static_cast<size_t>(s) * nt;  // the stream's first track

  int* ws = workspace + s * workspace_words(nt, nk);
  float* score = reinterpret_cast<float*>(ws);
  float* sim_of = reinterpret_cast<float*>(ws + static_cast<size_t>(nt) * nk);
  int* det_for_track = ws + static_cast<size_t>(nt) * nk + nt;
  int* src_of = det_for_track + nt;
  int* track_for_det = src_of + nt;
  int* unmatched = track_for_det + nk;

  for (size_t e = tid; e < static_cast<size_t>(nt) * d; e += nthreads)
    st.emb[s0 * d + e] = in.emb[s0 * d + e];
  for (int t = tid; t < nt; t += nthreads) {
    const size_t i = s0 + t;
    for (int c = 0; c < 4; ++c) st.box[i * 4 + c] = in.box[i * 4 + c];
    st.active[i] = in.active[i];
    st.has_prev[i] = in.has_prev[i];
    st.counter[i] = in.counter[i];
    st.flagged[i] = in.flagged[i];
    st.processed[i] = in.processed[i];
    st.misses[i] = in.misses[i];
    st.final_counter[i] = in.final_counter[i];
  }
  const int nv = n_valid_dev ? n_valid_dev[s] : n_valid;
  const int rounds = min(nt, nk);
  __syncthreads();

  for (int fi = 0; fi < f; ++fi) {
    const bool live = fi < nv;  // a frame past n_valid has no detections and keeps the state
    const size_t f0 = (static_cast<size_t>(s) * f + fi) * nk;  // the frame's first detection
    const float* dbox = boxes + f0 * 4;

    // The score matrix: iou_matrix(plus_one=False) of track t and detection
    // k, -1 where the track is inactive or the detection invalid.
    for (int e = tid; e < nt * nk; e += nthreads) {
      const int t = e / nk, k = e - t * nk;
      float v = -1.0f;
      if (st.active[s0 + t] && live && valid[f0 + k]) {
        const float* a = st.box + (s0 + t) * 4;
        const float* b = dbox + k * 4;
        const float ix = fmaxf(fminf(a[2], b[2]) - fmaxf(a[0], b[0]) + 0.0f, 0.0f);
        const float iy = fmaxf(fminf(a[3], b[3]) - fmaxf(a[1], b[1]) + 0.0f, 0.0f);
        const float inter = ix * iy;
        const float area_a = (a[2] - a[0] + 0.0f) * (a[3] - a[1] + 0.0f);
        const float area_b = (b[2] - b[0] + 0.0f) * (b[3] - b[1] + 0.0f);
        v = inter / fmaxf(area_a + area_b - inter, 1e-12f);
      }
      score[e] = v;
    }
    for (int t = tid; t < nt; t += nthreads) det_for_track[t] = -1;
    for (int k = tid; k < nk; k += nthreads) track_for_det[k] = -1;
    __syncthreads();

    // Greedy match: min(T, K) rounds of a flat argmax (the first maximum in
    // (t, k) row-major order); a maximum at or above match_iou pairs its
    // track and detection; either way its row and column drop out.
    if (warp == 0) {
      for (int r = 0; r < rounds; ++r) {
        float best = -INFINITY;
        int at = 0x7fffffff;
        for (int e = lane; e < nt * nk; e += 32) {
          const float v = score[e];
          if (v > best) {
            best = v;
            at = e;
          }
        }
        for (int off = 16; off; off >>= 1) {
          const float ob = __shfl_xor_sync(kFull, best, off);
          const int oa = __shfl_xor_sync(kFull, at, off);
          if (ob > best || (ob == best && oa < at)) {
            best = ob;
            at = oa;
          }
        }
        const int t = at / nk, k = at - t * nk;
        if (lane == 0 && best >= rules.match_iou) {
          det_for_track[t] = k;
          track_for_det[k] = t;
        }
        __syncwarp();
        for (int e = lane; e < nk; e += 32) score[t * nk + e] = -1.0f;
        for (int e = lane; e < nt; e += 32) score[e * nk + k] = -1.0f;
        __syncwarp();
      }
    }
    __syncthreads();

    // Similarity of matched tracks with a previous embedding: a warp per
    // track, dot / clamp_min(|a| |b|, 1e-12).
    for (int t = warp; t < nt; t += nwarps) {
      const int k = det_for_track[t];
      float sim = 0.0f;
      if (k >= 0 && st.has_prev[s0 + t]) {
        const float* a = det_emb + (f0 + k) * d;
        const float* b = st.emb + (s0 + t) * d;
        float dot = 0.0f, aa = 0.0f, bb = 0.0f;
        for (int j = lane; j < d; j += 32) {
          const float x = a[j], y = b[j];
          dot += x * y;
          aa += x * x;
          bb += y * y;
        }
        for (int off = 16; off; off >>= 1) {
          dot += __shfl_xor_sync(kFull, dot, off);
          aa += __shfl_xor_sync(kFull, aa, off);
          bb += __shfl_xor_sync(kFull, bb, off);
        }
        sim = dot / fmaxf(sqrtf(aa) * sqrtf(bb), 1e-12f);
      }
      if (lane == 0) sim_of[t] = sim;
    }
    __syncthreads();

    // The per-track rules, a lane per track in chunks of 32: counter and
    // flag, misses and retirement, then unmatched detections claim free
    // slots in detection order, the r-th free slot the r-th unmatched
    // detection for r < min(T, K).
    if (warp == 0) {
      int n_unmatched = 0;
      for (int c0 = 0; c0 < nk; c0 += 32) {
        const int k = c0 + lane;
        const bool um = k < nk && live && valid[f0 + k] && track_for_det[k] < 0;
        const unsigned ballot = __ballot_sync(kFull, um);
        if (um) unmatched[n_unmatched + __popc(ballot & ((1u << lane) - 1u))] = k;
        n_unmatched += __popc(ballot);
      }
      __syncwarp();
      int n_free = 0;
      for (int c0 = 0; c0 < nt; c0 += 32) {
        const int t = c0 + lane;
        const bool is_t = t < nt;
        const size_t i = s0 + (is_t ? t : 0);
        const int k = is_t ? det_for_track[t] : -1;
        const bool matched = k >= 0;
        const bool active = is_t && st.active[i];
        const bool has_prev = is_t && st.has_prev[i];
        const bool update = matched && has_prev;
        const float sim = is_t ? sim_of[t] : 0.0f;
        int counter = is_t ? st.counter[i] : 0;
        if (update) counter = sim < rules.similarity_threshold ? counter + 1 : 0;
        const bool flagged = update && counter > rules.run_length_threshold;
        const int misses = matched ? 0 : (is_t ? st.misses[i] : 0) + (active ? 1 : 0);
        const bool kept = (active && misses <= rules.max_misses) || matched;
        const unsigned free_slots = __ballot_sync(kFull, is_t && !kept);
        const int rank = n_free + __popc(free_slots & ((1u << lane) - 1u));
        n_free += __popc(free_slots);
        if (!is_t) continue;
        const int spawn = !kept && rank < rounds && rank < n_unmatched ? unmatched[rank] : -1;
        const bool spawns = spawn >= 0;
        const int src = matched ? k : spawn;
        float box[4];
        for (int c = 0; c < 4; ++c) box[c] = src >= 0 ? dbox[src * 4 + c] : st.box[i * 4 + c];
        const bool now_active = kept || spawns;
        const size_t o = (static_cast<size_t>(s) * f + fi) * nt + t;
        out.flagged[o] = flagged;
        out.sim[o] = sim;
        for (int c = 0; c < 4; ++c) out.box[o * 4 + c] = box[c];
        out.active[o] = now_active;
        out.updated[o] = update;
        if (live) {
          // A spawned track starts a fresh history, its counts included.
          for (int c = 0; c < 4; ++c) st.box[i * 4 + c] = box[c];
          st.active[i] = now_active;
          st.has_prev[i] = matched || spawns || has_prev;
          st.counter[i] = spawns ? 0 : counter;
          st.flagged[i] = spawns ? 0 : st.flagged[i] + (flagged ? 1 : 0);
          st.processed[i] = spawns ? 0 : st.processed[i] + (update ? 1 : 0);
          st.misses[i] = spawns ? 0 : misses;
          st.final_counter[i] = spawns ? 0 : (update ? counter : st.final_counter[i]);
        }
        src_of[t] = live ? src : -1;
      }
    }
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const int k = src_of[t];
      if (k < 0) continue;
      const float* a = det_emb + (f0 + k) * d;
      for (int j = tid; j < d; j += nthreads) st.emb[(s0 + t) * d + j] = a[j];
    }
    __syncthreads();
  }
}

}  // namespace

// The int32 words of workspace that tt_track_fold takes per stream.
extern "C" long long tt_track_fold_workspace_words(int t, int k) {
  return static_cast<long long>(workspace_words(t, k));
}

// State in and out: active (S, T) u8, box (S, T, 4) f32, embedding (S, T, D)
// f32, has_prev (S, T) u8, then counter, flagged_count, processed, misses,
// final_counter (S, T) int32.  Detections: boxes (S, F, K, 4) f32, valid
// (S, F, K) u8, embeddings (S, F, K, D) f32.  n_valid per stream from
// n_valid_dev (S,) int32 when it is not null, else the int n_valid for
// every stream.  Per-frame outputs (S, F, T): flagged u8, sim f32, box
// (.., 4) f32, active u8, updated u8.  workspace: S x
// tt_track_fold_workspace_words(T, K) int32.  All contiguous; the outputs
// and the workspace overlap no input.  Any S, F, T, K, D >= 0.
extern "C" int tt_track_fold(
    const void* active, const void* box, const void* emb, const void* has_prev,
    const void* counter, const void* flagged_count, const void* processed, const void* misses,
    const void* final_counter, const void* det_boxes, const void* det_valid, const void* det_emb,
    const void* n_valid_dev, int n_valid, void* o_active, void* o_box, void* o_emb,
    void* o_has_prev, void* o_counter, void* o_flagged_count, void* o_processed, void* o_misses,
    void* o_final_counter, void* out_flagged, void* out_sim, void* out_box, void* out_active,
    void* out_updated, void* workspace, int s, int f, int t, int k, int d,
    float similarity_threshold, int run_length_threshold, float match_iou, int max_misses,
    void* stream) {
  if (s < 0 || f < 0 || t < 0 || k < 0 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (s == 0 || t == 0) return 0;
  const StateIn in{static_cast<const uint8_t*>(active), static_cast<const float*>(box),
                   static_cast<const float*>(emb), static_cast<const uint8_t*>(has_prev),
                   static_cast<const int*>(counter), static_cast<const int*>(flagged_count),
                   static_cast<const int*>(processed), static_cast<const int*>(misses),
                   static_cast<const int*>(final_counter)};
  const State st{static_cast<uint8_t*>(o_active), static_cast<float*>(o_box),
                 static_cast<float*>(o_emb), static_cast<uint8_t*>(o_has_prev),
                 static_cast<int*>(o_counter), static_cast<int*>(o_flagged_count),
                 static_cast<int*>(o_processed), static_cast<int*>(o_misses),
                 static_cast<int*>(o_final_counter)};
  const FrameOut out{static_cast<uint8_t*>(out_flagged), static_cast<float*>(out_sim),
                     static_cast<float*>(out_box), static_cast<uint8_t*>(out_active),
                     static_cast<uint8_t*>(out_updated)};
  const Rules rules{similarity_threshold, run_length_threshold, match_iou, max_misses};
  const dim3 grid(s), block(32 * min(t, kMaxWarps));
  track_fold_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const float*>(det_boxes), static_cast<const uint8_t*>(det_valid),
      static_cast<const float*>(det_emb), static_cast<const int*>(n_valid_dev), n_valid, st, out,
      static_cast<int*>(workspace), f, t, k, d, rules);
  return static_cast<int>(cudaGetLastError());
}
