// Fused frame-step scan of the static-network 1-best decoder for Hopper
// (sm_90a): a persistent kernel, one thread block per utterance, the frame
// loop inside the block.
//
// Replaces the Pallas TPU kernel `PallasDecodeScan._kernel` of
// juicer_tpu/decoder/pallas_scan.py (helpers `_cumsum_lanes`, `_gather_rows`,
// wrapper `_build_call`). It computes what `TorchDecoder._frame_step`
// (juicer_tpu_torch/decoder/core.py, this kernel's plain PyTorch version)
// computes, for B utterances over a run of frames, and is held to it bit for
// bit: HMM-internal max-plus propagation with first-max payloads, the emit
// beam and the binned histogram threshold, HMM exit, the phone-end and
// word-end beams, exclusive prefix sums of closure fan-outs, closure-entry
// and final-entry gathers, per-arc recombination (best score, ties to the
// lowest candidate index), slot routing (the arc's live slot, else the next
// free slot in candidate order), insertion, one traceback record per landed
// winner, the per-frame best-final snapshot, overflow flags and counters.
//
// What changed from the TPU design, and why:
//   - the TPU's sequential grid over frames is a loop inside the block; the
//     carry enters and leaves through device memory, so one launch per
//     utterance batch or a call per piece of it (carry and first frame
//     number handed in) give the same result;
//   - utterances never interact, so the batch axis is the grid (any B >= 1;
//     the TPU's sublane groups of 8 are gone);
//   - tables stay in device memory (L2 at these sizes) and are gathered by
//     integer index: no one-hot matmuls, no table-size limit, and the
//     int64 columns of the plain version's tables are read as they are (no
//     second copy of the entry tables on the card);
//   - arc ids, rows, slots and record ids are integers (the TPU carried them
//     in f32); a launch needs (t0 + T) * K < 2^31;
//   - prefix sums are block scans built from warp shuffles;
//   - the dense (E, E) recombination compare is a shared-memory hash table
//     keyed by target arc: atomicMax of (order-preserving score bits << 32 |
//     ~candidate index) picks the best score with ties to the lowest index,
//     whatever order threads arrive in; seeding the same table with the live
//     slots' arcs gives the hit lookup;
//   - the histogram threshold (maxHyps), which the TPU kernel refuses, is a
//     shared-memory integer histogram and a top-down block scan.
//
// Every float result is one add or subtract, a max or a select, so there is
// no float sum whose order could matter, and the counters are integers.
//
// What bounds it on an H100: neither bytes nor operations. A frame is about
// thirty block-wide barriers around short dependent stages (a slot's
// metadata gather, a candidate's binary search and four table gathers, the
// hash probe), and only B of the card's 132 SMs are busy. Per frame and
// utterance it must move the (G) scores in and seven (K) record planes out:
// tens of KB, microseconds at most at 3.35 TB/s. The design keeps the whole
// frontier, the candidates, the hash table and the histogram in shared
// memory (about 203 KB at K=1024, E=1408, S=5), so a frame's only device
// memory traffic is the gathers and the record writes. Making it faster
// (splitting an utterance over a cluster, fewer barriers) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kNeg = -1.0e30f;
constexpr float kHalfNeg = -5.0e29f;  // NEG / 2 of the plain version, in float32
constexpr int kNoSlot = 0x7fffffff;
constexpr int kEmpty = -1;

// Pointer, integer and float arguments arrive as three host arrays, in the
// order of these enums (mirrored by decoder/fused_scan.py).
enum Ptr {
  P_ARC_META, P_ENT_ARC, P_ENT_SCORE, P_ENT_AC, P_ENT_SEQ, P_F_SCORE, P_F_AC,
  P_F_SEQ, P_TRP, P_EMITTING, P_STATE_GMM, P_SCORES,
  P_IN_ARC, P_IN_SCORE, P_IN_AC, P_IN_PATH, P_IN_BEST_EMIT, P_IN_BEST_START,
  P_IN_KTH, P_IN_NORM, P_IN_OVF,
  P_OUT_ARC, P_OUT_SCORE, P_OUT_AC, P_OUT_PATH, P_OUT_BEST_EMIT,
  P_OUT_BEST_START, P_OUT_KTH, P_OUT_NORM, P_OUT_OVF,
  P_OUT_BF_SCORE, P_OUT_BF_AC, P_OUT_BF_LM, P_OUT_BF_PATH, P_OUT_BF_SEQ,
  P_OUT_BF_SRC,
  P_REC_PREV, P_REC_SEQ, P_REC_SCORE, P_REC_AC, P_REC_LM, P_REC_SRC, P_REC_ARC,
  P_BF_SCORE, P_BF_AC, P_BF_LM, P_BF_PATH, P_BF_SEQ, P_BF_SRC, P_N_ACTIVE,
  P_N_CAND,
  N_PTR
};
enum Int {
  I_B, I_K, I_E, I_F, I_S, I_G, I_N_ARCS, I_N_ENT, I_N_FENT, I_N_BINS, I_HT,
  I_MAX_EMIT_HYPS, I_N_FRAMES, I_T_BASE, I_THREADS,
  N_INT
};
enum Flt { F_EMIT_WIN, F_START_WIN, F_END_WIN, F_WORD_WIN, F_HIST_MIN, F_HIST_MAX, N_FLT };

struct Params {
  const void* ptr[N_PTR];
  int i[N_INT];
  float f[N_FLT];
};

template <class T>
__device__ __forceinline__ T* at(const Params& p, int which) {
  return static_cast<T*>(const_cast<void*>(p.ptr[which]));
}

// order-preserving map of finite floats onto unsigned integers
__device__ __forceinline__ unsigned f2ord(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float ord2f(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
// recombination key: best score first, ties to the lowest index; -0.0 and
// +0.0 compare equal as floats, so both map to one key
__device__ __forceinline__ unsigned long long win_key(float score, int index) {
  const unsigned o = (score == 0.0f) ? f2ord(0.0f) : f2ord(score);
  return (static_cast<unsigned long long>(o) << 32) | (0xffffffffu - static_cast<unsigned>(index));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ unsigned long long warp_max_u64(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// smallest index whose value exceeds x, in a non-decreasing array
__device__ __forceinline__ int upper_bound(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > x) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// find-or-insert `arc` in the open-addressing table; returns its position
__device__ __forceinline__ int ht_insert(int* keys, int mask, int arc) {
  unsigned h = static_cast<unsigned>(arc) * 2654435761u;
  h = (h ^ (h >> 15)) & mask;
  while (true) {
    const int old = atomicCAS(&keys[h], kEmpty, arc);
    if (old == kEmpty || old == arc) return static_cast<int>(h);
    h = (h + 1) & mask;
  }
}

// Block-wide exclusive prefix sum of load(0..n-1); store(i, exclusive, own)
// is called for every i; returns the total to every thread. All threads of
// the block must call it. `ws` is 33 ints of shared scratch.
template <class Load, class Store>
__device__ __forceinline__ int block_scan(int n, int* ws, Load load, Store store) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += nt) {
    const int i = base + tid;
    const int v = (i < n) ? load(i) : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) ws[wid] = x;
    __syncthreads();
    if (wid == 0) {
      const int w = (lane < nw) ? ws[lane] : 0;
      int s = w;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += y;
      }
      ws[lane] = s - w;
      if (lane == 31) ws[32] = s;
    }
    __syncthreads();
    if (i < n) store(i, carry + ws[wid] + x - v, v);
    carry += ws[32];
    __syncthreads();
  }
  return carry;
}

struct Shared {
  unsigned red_emit, red_end, red_entry;
  int n_live, n_active, hist_r;
  unsigned long long fbest;
  int ws[33];
};

__host__ __device__ inline size_t rup4(size_t n) { return (n + 3) & ~static_cast<size_t>(3); }

// dynamic shared memory of one block, in bytes (mirrored by fused_scan.py)
__host__ __device__ inline size_t smem_bytes(int K, int E, int S, int G, int n_bins, int HT) {
  return 8 * static_cast<size_t>(HT) +
         4 * (2 * static_cast<size_t>(HT) + (3 * static_cast<size_t>(S) + 9) * rup4(K) +
              7 * rup4(E) + rup4(n_bins) + rup4(G));
}

template <int S>
__global__ void __launch_bounds__(kMaxThreads) frame_step_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Shared sh;

  const int B = p.i[I_B], K = p.i[I_K], E = p.i[I_E], F = p.i[I_F], G = p.i[I_G];
  const int n_arcs = p.i[I_N_ARCS], n_ent = p.i[I_N_ENT], n_fent = p.i[I_N_FENT];
  const int n_bins = p.i[I_N_BINS], HT = p.i[I_HT], max_hyps = p.i[I_MAX_EMIT_HYPS];
  const int dead = n_arcs + 1;
  const float emit_win = p.f[F_EMIT_WIN], start_win = p.f[F_START_WIN];
  const float end_win = p.f[F_END_WIN], word_win = p.f[F_WORD_WIN];
  const float hist_min = p.f[F_HIST_MIN], hist_max = p.f[F_HIST_MAX];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int Kr = ((K + nt - 1) / nt) * nt, Er = ((E + nt - 1) / nt) * nt;
  const int K4 = static_cast<int>(rup4(K)), E4 = static_cast<int>(rup4(E));

  // ---- carve the dynamic shared memory --------------------------------
  unsigned long long* ht_val = reinterpret_cast<unsigned long long*>(smem_raw);
  int* ht_key = reinterpret_cast<int*>(ht_val + HT);
  int* ht_slot = ht_key + HT;
  float* s_score = reinterpret_cast<float*>(ht_slot + HT);  // (S, K)
  float* s_ac = s_score + S * K4;                           // (S, K)
  int* s_path = reinterpret_cast<int*>(s_ac + S * K4);      // (S, K)
  int* s_arc = s_path + S * K4;
  float* s_exsc = reinterpret_cast<float*>(s_arc + K4);     // exit score / ac / path
  float* s_exac = s_exsc + K4;
  int* s_expa = reinterpret_cast<int*>(s_exac + K4);
  int* s_a = s_expa + K4;   // inclusive entry fan-out scan; later the free-slot list
  int* s_b = s_a + K4;      // entry base row; later the landed winner of a slot
  int* s_c = s_b + K4;      // inclusive final fan-out scan
  int* s_d = s_c + K4;      // final base row
  int* s_live = s_d + K4;
  int* c_arc = s_live + K4;                                  // candidates (E)
  float* c_score = reinterpret_cast<float*>(c_arc + E4);
  float* c_ac = c_score + E4;
  int* c_prev = reinterpret_cast<int*>(c_ac + E4);
  int* c_seq = c_prev + E4;
  int* c_src = c_seq + E4;
  int* c_h = c_src + E4;    // hash position; then the routing code of a winner
  int* s_hist = c_h + E4;
  float* s_gmm = reinterpret_cast<float*>(s_hist + rup4(n_bins));

  const long long* arc_meta = at<const long long>(p, P_ARC_META);
  const long long* ent_arc = at<const long long>(p, P_ENT_ARC);
  const float* ent_score = at<const float>(p, P_ENT_SCORE);
  const float* ent_ac = at<const float>(p, P_ENT_AC);
  const long long* ent_seq = at<const long long>(p, P_ENT_SEQ);
  const float* f_score = at<const float>(p, P_F_SCORE);
  const float* f_ac = at<const float>(p, P_F_AC);
  const long long* f_seq = at<const long long>(p, P_F_SEQ);
  const float* trP = at<const float>(p, P_TRP);
  const unsigned char* emitting = at<const unsigned char>(p, P_EMITTING);
  const long long* state_gmm = at<const long long>(p, P_STATE_GMM);
  const float* scores = at<const float>(p, P_SCORES);

  // ---- carry in ----------------------------------------------------------
  {
    const long long* in_arc = at<const long long>(p, P_IN_ARC);
    const float* in_score = at<const float>(p, P_IN_SCORE);
    const float* in_ac = at<const float>(p, P_IN_AC);
    const long long* in_path = at<const long long>(p, P_IN_PATH);
    for (int k = tid; k < K; k += nt) {
      const size_t row = static_cast<size_t>(b) * K + k;
      s_arc[k] = static_cast<int>(in_arc[row]);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        s_score[s * K4 + k] = in_score[row * S + s];
        s_ac[s * K4 + k] = in_ac[row * S + s];
        s_path[s * K4 + k] = static_cast<int>(in_path[row * S + s]);
      }
    }
  }
  // per-utterance scalars: every thread keeps the same copy in registers
  float best_emit = at<const float>(p, P_IN_BEST_EMIT)[b];
  float best_start = at<const float>(p, P_IN_BEST_START)[b];
  float kth_emit = at<const float>(p, P_IN_KTH)[b];
  float norm = at<const float>(p, P_IN_NORM)[b];
  int overflow = at<const unsigned char>(p, P_IN_OVF)[b] ? 1 : 0;
  float bf_score = kNeg, bf_ac = kNeg, bf_lm = kNeg;
  int bf_path = -1, bf_seq = 0, bf_src = -1;
  __syncthreads();

  for (int f = 0; f < p.i[I_N_FRAMES]; ++f) {
    const size_t row_tb = static_cast<size_t>(f) * B + b;
    const int t = p.i[I_T_BASE] + f;

    // ---- frame scalars; load the frame's scores; clear the tables ------
    const float normalise = best_emit > kHalfNeg ? best_emit : 0.0f;
    norm = norm + normalise;
    float emit_thresh;
    if (max_hyps > 0) {
      emit_thresh = kth_emit - normalise;
      if (emit_win > 0.0f) emit_thresh = fmaxf(emit_thresh, -emit_win);
    } else {
      emit_thresh = emit_win > 0.0f ? -emit_win : kNeg;
    }
    const float start_thresh = best_start - start_win;
    for (int g = tid; g < G; g += nt) s_gmm[g] = scores[row_tb * G + g];
    for (int i = tid; i < n_bins; i += nt) s_hist[i] = 0;
    for (int i = tid; i < HT; i += nt) {
      ht_val[i] = 0ull;
      ht_key[i] = kEmpty;
      ht_slot[i] = kNoSlot;
    }
    if (tid == 0) {
      sh.red_emit = sh.red_end = sh.red_entry = f2ord(kNeg);
      sh.n_live = sh.n_active = 0;
      sh.hist_r = 0;
      sh.fbest = 0ull;
    }
    __syncthreads();

    // ---- A. internal propagation, emit beam, histogram counts, exit ----
    for (int k = tid; k < Kr; k += nt) {
      float m_emit = kNeg, m_end = kNeg;
      bool live = false;
      if (k < K) {
        const int arc = s_arc[k];
        const bool is_dead = arc > n_arcs;
        const int hmm = static_cast<int>(arc_meta[static_cast<size_t>(min(arc, dead)) * 6]);
        const float* tr = trP + static_cast<size_t>(hmm) * S * S;
        float sc[S], ac[S];
        int pa[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          sc[s] = s_score[s * K4 + k];
          ac[s] = s_ac[s * K4 + k];
          pa[s] = s_path[s * K4 + k];
        }
        if (start_win > 0.0f && sc[0] < start_thresh) sc[0] = kNeg;
        float exit_best = 0.0f, exit_ac = 0.0f;
        int exit_pa = -1;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          // first max over predecessors i of sc[i] + trP[i, j]
          float w = is_dead ? kNeg : __ldg(tr + j);
          float best = sc[0] + w, bac = ac[0] + w;
          int bpa = pa[0];
#pragma unroll
          for (int i = 1; i < S; ++i) {
            w = is_dead ? kNeg : __ldg(tr + i * S + j);
            const float m = sc[i] + w;
            if (m > best) {
              best = m;
              bac = ac[i] + w;
              bpa = pa[i];
            }
          }
          const float ns = best - normalise;
          const bool pass = emitting[hmm * S + j] && ns > emit_thresh && best > kHalfNeg;
          const float outp = s_gmm[static_cast<int>(state_gmm[hmm * S + j])];
          const float s2 = pass ? ns + outp : kNeg;
          const float a2 = pass ? bac + outp : kNeg;
          const int p2 = pass ? bpa : -1;
          s_score[j * K4 + k] = s2;
          s_ac[j * K4 + k] = a2;
          s_path[j * K4 + k] = p2;
          m_emit = fmaxf(m_emit, s2);
          if (j < S - 1 && s2 > kHalfNeg) live = true;
          if (max_hyps > 0 && s2 > kHalfNeg) {
            float r = truncf(s2 < 0.0f ? s2 - 0.5f : s2 + 0.5f);
            r = fminf(r, hist_max);
            if (r >= hist_min) atomicAdd(&s_hist[static_cast<int>(r - hist_min)], 1);
          }
          // exit state: first max over j of s2[j] + trP[j, S-1]
          const float we = is_dead ? kNeg : __ldg(tr + j * S + (S - 1));
          const float ec = s2 + we;
          if (j == 0 || ec > exit_best) {
            exit_best = ec;
            exit_ac = a2 + we;
            exit_pa = p2;
          }
        }
        const bool exit_ok = exit_best > kHalfNeg;
        s_exsc[k] = exit_ok ? exit_best : kNeg;
        s_exac[k] = exit_ok ? exit_ac : kNeg;
        s_expa[k] = exit_ok ? exit_pa : -1;
        m_end = exit_ok ? exit_best : kNeg;
        live = live && arc <= n_arcs && arc >= 0;
        s_live[k] = live ? 1 : 0;
      }
      m_emit = warp_max(m_emit);
      m_end = warp_max(m_end);
      const unsigned n_l = __popc(__ballot_sync(0xffffffffu, live));
      if (lane == 0) {
        atomicMax(&sh.red_emit, f2ord(m_emit));
        atomicMax(&sh.red_end, f2ord(m_end));
        if (n_l) atomicAdd(&sh.n_live, static_cast<int>(n_l));
      }
    }
    __syncthreads();

    // ---- B. exit beams, fan-outs, prefix sums, histogram threshold ------
    const float best_emit_new = ord2f(sh.red_emit);
    const float best_end = ord2f(sh.red_end);
    const int n_live = sh.n_live;
    const float end_thresh = end_win > 0.0f ? best_end - end_win : kNeg;
    const float word_thresh = word_win > 0.0f ? best_end - word_win : kNeg;
    for (int k = tid; k < K; k += nt) {
      const int arc = s_arc[k];
      const long long* meta = arc_meta + static_cast<size_t>(min(arc, dead)) * 6;
      const float ex = s_exsc[k];
      const float thr = meta[1] == 0 ? end_thresh : word_thresh;
      const bool live_exit = ex > kHalfNeg && ex > thr && arc <= n_arcs;
      s_b[k] = live_exit ? static_cast<int>(meta[2]) : 0;
      s_a[k] = live_exit ? static_cast<int>(meta[3]) : 0;
      s_d[k] = live_exit ? static_cast<int>(meta[4]) : 0;
      s_c[k] = live_exit ? static_cast<int>(meta[5]) : 0;
    }
    const int total = block_scan(K, sh.ws, [&](int i) { return s_a[i]; },
                                 [&](int i, int excl, int v) { s_a[i] = excl + v; });
    const int ftotal = block_scan(K, sh.ws, [&](int i) { return s_c[i]; },
                                  [&](int i, int excl, int v) { s_c[i] = excl + v; });
    if (max_hyps > 0) {
      // top-down cumulative count: r counts bins from the top
      const int n_hist = block_scan(
          n_bins, sh.ws, [&](int r) { return s_hist[n_bins - 1 - r]; },
          [&](int r, int excl, int v) {
            if (excl < max_hyps && excl + v >= max_hyps) sh.hist_r = r;
          });
      kth_emit = n_hist > max_hyps
                     ? (hist_min + static_cast<float>(n_bins - 1 - sh.hist_r)) - 0.5f
                     : hist_min - 0.5f;
    }

    // ---- C. closure expansion into candidates; finals; hash inserts ------
    const int n_c = min(total, E);
    for (int e = tid; e < E; e += nt) {
      int h = -1;
      float g_score = kNeg;
      int g_arc = dead;
      if (e < n_c) {
        const int k = upper_bound(s_a, K, e);
        const int lo = k ? s_a[k - 1] : 0;
        long long row = static_cast<long long>(s_b[k]) + (e - lo);
        row = row < 0 ? 0 : (row > n_ent - 1 ? n_ent - 1 : row);
        const float csc = s_exsc[k] + ent_score[row];
        c_ac[e] = s_exac[k] + ent_ac[row];
        c_prev[e] = s_expa[k];
        c_seq[e] = static_cast<int>(ent_seq[row]);
        c_src[e] = s_arc[k];
        if (csc > kHalfNeg) {
          g_score = csc;
          g_arc = static_cast<int>(ent_arc[row]);
          h = ht_insert(ht_key, HT - 1, g_arc);
          atomicMax(&ht_val[h], win_key(csc, e));
        }
      }
      c_score[e] = g_score;
      c_arc[e] = g_arc;
      c_h[e] = h;
    }
    for (int k = tid; k < K; k += nt) {
      if (s_live[k]) atomicMin(&ht_slot[ht_insert(ht_key, HT - 1, s_arc[k])], k);
    }
    {
      // this frame's best final-state reach: first max over the F positions
      const int n_f = min(ftotal, F);
      unsigned long long fkey = 0ull;
      for (int q = tid; q < n_f; q += nt) {
        const int k = upper_bound(s_c, K, q);
        const int lo = k ? s_c[k - 1] : 0;
        long long row = static_cast<long long>(s_d[k]) + (q - lo);
        row = row < 0 ? 0 : (row > n_fent - 1 ? n_fent - 1 : row);
        const unsigned long long key = win_key(s_exsc[k] + f_score[row], q);
        fkey = key > fkey ? key : fkey;
      }
      fkey = warp_max_u64(fkey);
      if (lane == 0 && fkey) atomicMax(&sh.fbest, fkey);
    }
    __syncthreads();

    {
      bf_score = bf_ac = bf_lm = kNeg;
      bf_path = -1;
      bf_seq = 0;
      bf_src = -1;
      const unsigned long long fkey = sh.fbest;
      if (fkey) {
        const int q = static_cast<int>(0xffffffffu - static_cast<unsigned>(fkey));
        const int k = upper_bound(s_c, K, q);
        const int lo = k ? s_c[k - 1] : 0;
        long long row = static_cast<long long>(s_d[k]) + (q - lo);
        row = row < 0 ? 0 : (row > n_fent - 1 ? n_fent - 1 : row);
        const float s_i = s_exsc[k] + f_score[row];
        if (s_i > kNeg) {
          const float a_i = s_exac[k] + f_ac[row];
          bf_score = s_i;
          bf_ac = a_i;
          bf_lm = (s_i - a_i) + norm;
          bf_path = s_expa[k];
          bf_seq = static_cast<int>(f_seq[row]);
          bf_src = s_arc[k];
        }
      }
    }

    // ---- D. winners and their routing codes -----------------------------
    // code >= 0: the arc's live slot; -1: not a winner; <= -2: needs a new
    // slot, rank -2 - code among such winners in candidate order
    for (int e = tid; e < n_c; e += nt) {
      const int h = c_h[e];
      int code = -1;
      if (h >= 0 && static_cast<unsigned>(ht_val[h]) == 0xffffffffu - static_cast<unsigned>(e)) {
        const int sl = ht_slot[h];
        code = sl != kNoSlot ? sl : -2;
      }
      c_h[e] = code;
    }
    const int n_new = block_scan(n_c, sh.ws, [&](int e) { return c_h[e] == -2 ? 1 : 0; },
                                 [&](int e, int excl, int v) { if (v) c_h[e] = -2 - excl; });
    const int n_free = K - n_live;
    // free slots in slot order
    block_scan(K, sh.ws, [&](int k) { return s_live[k] ? 0 : 1; },
               [&](int k, int excl, int v) { if (v) s_a[excl] = k; });
    for (int k = tid; k < K; k += nt) s_b[k] = -1;
    __syncthreads();

    // ---- E. winners take their slots -------------------------------------
    for (int e = tid; e < Er; e += nt) {
      float m_entry = kNeg;
      if (e < n_c) {
        const int code = c_h[e];
        int slot = -1;
        if (code >= 0) {
          slot = code;
        } else if (code <= -2 && -2 - code < n_free) {
          slot = s_a[-2 - code];
        }
        if (slot >= 0) {
          s_b[slot] = e;
          m_entry = c_score[e];
        }
      }
      m_entry = warp_max(m_entry);
      if (lane == 0) atomicMax(&sh.red_entry, f2ord(m_entry));
    }
    __syncthreads();

    // ---- F. insertion and this frame's records ---------------------------
    {
      int* rec_prev = at<int>(p, P_REC_PREV);
      int* rec_seq = at<int>(p, P_REC_SEQ);
      float* rec_score = at<float>(p, P_REC_SCORE);
      float* rec_ac = at<float>(p, P_REC_AC);
      float* rec_lm = at<float>(p, P_REC_LM);
      int* rec_src = at<int>(p, P_REC_SRC);
      int* rec_arc = at<int>(p, P_REC_ARC);
      for (int k = tid; k < Kr; k += nt) {
        bool active = false;
        if (k < K) {
          const int e = s_b[k];
          const bool live = s_live[k] != 0;
          const size_t o = row_tb * K + k;
          int r_prev = -1, r_seq = 0, r_src = -1, r_arc = -1;
          float r_score = kNeg, r_ac = kNeg, r_lm = kNeg;
          if (e >= 0) {
            const int l_arc = c_arc[e], l_prev = c_prev[e], l_seq = c_seq[e];
            const float l_score = c_score[e], l_ac = c_ac[e];
            s_score[k] = l_score;
            s_ac[k] = l_ac;
            s_path[k] = l_seq != 0 ? t * K + k : l_prev;
            s_arc[k] = l_arc;
            if (l_seq != 0) {
              r_prev = l_prev;
              r_seq = l_seq;
              r_score = l_score;
              r_ac = l_ac;
              r_lm = (l_score - l_ac) + norm;
              r_src = c_src[e];
              r_arc = l_arc;
            }
          } else {
            s_score[k] = kNeg;
            s_ac[k] = kNeg;
            s_path[k] = -1;
            if (!live) s_arc[k] = dead;
          }
          rec_prev[o] = r_prev;
          rec_seq[o] = r_seq;
          rec_score[o] = r_score;
          rec_ac[o] = r_ac;
          rec_lm[o] = r_lm;
          rec_src[o] = r_src;
          rec_arc[o] = r_arc;
          active = live || e >= 0;
        }
        const unsigned n_a = __popc(__ballot_sync(0xffffffffu, active));
        if (lane == 0 && n_a) atomicAdd(&sh.n_active, static_cast<int>(n_a));
      }
    }
    const float best_entry = ord2f(sh.red_entry);
    best_emit = fmaxf(best_emit_new, best_entry);
    best_start = best_entry;
    overflow |= (total > E) | (n_new > n_free) | (ftotal > F);
    __syncthreads();

    if (tid == 0) {
      at<float>(p, P_BF_SCORE)[row_tb] = bf_score;
      at<float>(p, P_BF_AC)[row_tb] = bf_ac;
      at<float>(p, P_BF_LM)[row_tb] = bf_lm;
      at<int>(p, P_BF_PATH)[row_tb] = bf_path;
      at<int>(p, P_BF_SEQ)[row_tb] = bf_seq;
      at<int>(p, P_BF_SRC)[row_tb] = bf_src;
      at<int>(p, P_N_ACTIVE)[row_tb] = sh.n_active;
      at<int>(p, P_N_CAND)[row_tb] = total;
    }
    // no barrier here: thread 0 alone resets the reducers at the top of the
    // next frame, after it has written them out above
  }

  // ---- carry out -----------------------------------------------------------
  {
    long long* out_arc = at<long long>(p, P_OUT_ARC);
    float* out_score = at<float>(p, P_OUT_SCORE);
    float* out_ac = at<float>(p, P_OUT_AC);
    long long* out_path = at<long long>(p, P_OUT_PATH);
    for (int k = tid; k < K; k += nt) {
      const size_t row = static_cast<size_t>(b) * K + k;
      out_arc[row] = s_arc[k];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        out_score[row * S + s] = s_score[s * K4 + k];
        out_ac[row * S + s] = s_ac[s * K4 + k];
        out_path[row * S + s] = s_path[s * K4 + k];
      }
    }
    if (tid == 0) {
      at<float>(p, P_OUT_BEST_EMIT)[b] = best_emit;
      at<float>(p, P_OUT_BEST_START)[b] = best_start;
      at<float>(p, P_OUT_KTH)[b] = kth_emit;
      at<float>(p, P_OUT_NORM)[b] = norm;
      at<unsigned char>(p, P_OUT_OVF)[b] = overflow ? 1 : 0;
      at<float>(p, P_OUT_BF_SCORE)[b] = bf_score;
      at<float>(p, P_OUT_BF_AC)[b] = bf_ac;
      at<float>(p, P_OUT_BF_LM)[b] = bf_lm;
      at<long long>(p, P_OUT_BF_PATH)[b] = bf_path;
      at<long long>(p, P_OUT_BF_SEQ)[b] = bf_seq;
      at<long long>(p, P_OUT_BF_SRC)[b] = bf_src;
    }
  }
}

template <int S>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        frame_step_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  frame_step_kernel<S><<<p.i[I_B], p.i[I_THREADS], smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory one block takes, in bytes.
extern "C" long long jtpu_frame_step_smem_bytes(int K, int E, int S, int G, int n_bins, int HT) {
  return static_cast<long long>(smem_bytes(K, E, S, G, n_bins, HT));
}

extern "C" int jtpu_frame_step_arg_counts(int* n_ptr, int* n_int, int* n_flt) {
  *n_ptr = N_PTR;
  *n_int = N_INT;
  *n_flt = N_FLT;
  return 0;
}

// Launches on `stream` one block per utterance over ints[I_N_FRAMES] frames.
// Returns cudaGetLastError() (0 = launched), or -1 for an unsupported S or
// thread count.
extern "C" int jtpu_frame_step(const void* const* ptrs, const int* ints, const float* flts,
                               void* stream) {
  Params p;
  for (int i = 0; i < N_PTR; ++i) p.ptr[i] = ptrs[i];
  for (int i = 0; i < N_INT; ++i) p.i[i] = ints[i];
  for (int i = 0; i < N_FLT; ++i) p.f[i] = flts[i];
  if (p.i[I_B] <= 0 || p.i[I_N_FRAMES] <= 0) return 0;
  const int nt = p.i[I_THREADS];
  if (nt < 32 || nt > kMaxThreads || nt % 32) return -1;
  const size_t smem =
      smem_bytes(p.i[I_K], p.i[I_E], p.i[I_S], p.i[I_G], p.i[I_N_BINS], p.i[I_HT]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.i[I_S]) {
    case 2: return launch<2>(p, smem, s);
    case 3: return launch<3>(p, smem, s);
    case 4: return launch<4>(p, smem, s);
    case 5: return launch<5>(p, smem, s);
    case 6: return launch<6>(p, smem, s);
    case 7: return launch<7>(p, smem, s);
    case 8: return launch<8>(p, smem, s);
    default: return -1;
  }
}
