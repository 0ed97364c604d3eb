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
//     one block fills an SM, so 132 utterances fill an H100);
//   - the entry tables stay in device memory and are gathered by integer
//     index: no one-hot matmuls, no table-size limit, the plain version's
//     own columns read in place;
//   - arc ids, rows, slots and record ids are integers (the TPU carried them
//     in f32); a launch needs (t0 + T) * K < 2^31;
//   - the dense (E, E) recombination compare is a shared-memory hash table
//     keyed by target arc (see below);
//   - the histogram threshold (maxHyps), which the TPU kernel refuses, is a
//     shared-memory integer histogram scanned from the top;
//   - the TPU kernel writes seven dense (K) record planes a frame; this one
//     writes only the records that landed (see "Records").
//
// What bounds it on an H100: neither bytes nor operations, but the chain of
// dependent stages inside one frame, which no second SM can share. Measured
// (harness/profile_decode.py --fused --clocks, the cycles of each phase
// from a build of this file with -DJTPU_FS_CLOCKS),
// a phase takes about the number of instructions of its busiest thread
// times the four to five cycles between dependent instructions, plus the
// device-memory latencies it waits for. The design therefore keeps that
// chain short:
//   - few, busy threads: a quarter of K threads a block (256 at K=1024; the
//     wrapper chooses), at most 512, so that every thread has 128 registers
//     and nothing spills. With 1,024 threads and 64 registers the spills
//     missed the small L1 that 216 KB of shared memory leave, and every
//     phase paid for it;
//   - only the slots that can hold something are visited: `bound` is one
//     past the highest slot that was active in one of the last two frames;
//     the slots above it are dead and hold exactly the dead state, so
//     propagation, scans, insertion and records leave them alone. Free
//     slots are the holes below `bound`, then bound, bound + 1, ...;
//   - eight block-wide barriers a frame. Prefix sums are fused: one pass
//     scans the exit count, both closure fan-outs and the histogram, a
//     second pass the new winners and the holes; a thread takes kIpt
//     consecutive items in registers, flag lanes are summed inside a warp
//     by ballots, warp totals cross one barrier on a double-buffered
//     scratch and every warp scans the totals itself;
//   - the only device-memory loads a frame waits for are one 32-byte row
//     of the int32 metadata table per live slot (asked for before the slot's
//     frontier is read from shared memory), the entry-table rows of the
//     candidates and the final-entry scores (asked for before the live
//     slots go into the recombination table). The HMM tables (transitions,
//     emitting flags, GMM ids) are staged in shared memory at kernel start
//     when they fit (the wrapper decides; a template flag, so that staged
//     reads are shared-memory loads), and the next frame's score row
//     arrives by cp.async while this frame computes, into the one row
//     buffer once phase A, its only reader, is done with it (G floats, not
//     2G: at G = 2,000 GMMs the buffer takes 8 KB, and a second one would
//     leave no room for E = 1,664 beside unstaged HMM tables);
//   - the recombination table is never cleared between frames: key, winner
//     and slot words carry the frame's generation, so an entry of an earlier
//     frame reads as empty. It is cleared only when the generation wraps
//     (every 2^g - 1 frames, g = min(16, 32 - bits of an arc id));
//   - the histogram is scanned from the bin of the frame's best score down,
//     kHistWindow bins together with the exits (further down only if the
//     sum has not reached maxHyps by then), and only in a frame that
//     counted more than maxHyps states; the bins a slot counted into are
//     cleared when the slot is written, not by a pass over all bins;
//   - candidates search the compacted list of the slots that exit this
//     frame, not all K slots;
//   - the best-final snapshot is read by one thread alone (lane 0 of the
//     last warp, which has the least to do), its loads in flight while
//     the block goes on;
//   - the frontier is slot-major with a compile-time odd stride, so a
//     slot's states sit at constant offsets (no address arithmetic) and
//     neighbouring slots fall into different banks.
//
// Recombination: open addressing keyed by target arc. Each valid candidate
// does one atomicMax of (generation << 48 | order-preserving score bits <<
// 16 | ~candidate index): the best score wins, ties go to the lowest index,
// whatever order threads arrive in; -0.0 and +0.0 share a key. Live slots
// put their slot number into the same table (atomicMin), which is the hit
// lookup.
//
// Records: per utterance an arena of 32-byte records in (frame, slot)
// order, which is ascending record id t*K + slot: eight int32 words
// {id, prev, seq, score, ac, lm, src, arc}, the three floats as their bit
// patterns (an array of structs, so one thread writes one record with two
// 16-byte stores). A record's position comes from warp ballots and the
// per-warp counts, read after the barrier that ends the frame, so the order
// is the same in every run. A (T, B) plane holds the running record count
// at the end of each frame of this launch.
//
// Shared memory, about 219 KB of the 227 KB a block may take at K=1024,
// E=1408, S=5, H=47: the table 64 KB (16 bytes an entry), the frontier
// 60 KB, ten (K) and seven (E) work planes 79 KB (reused across phases,
// as noted at their declarations), the histogram 4 KB, the staged HMM
// tables 5.6 KB (H*S*(S+1) words), the score row and the warps' record
// counts 0.8 KB. Where the search state (table, frontier, work and
// candidate planes) does not fit, as for the thousands of live HMM
// instances of a tied-state triphone system at the same beams (K=8,576
// and E=12,672 take 1.7 MB), it lies in the block's part of a workspace
// in device memory (a template flag, so that the shared-memory kernel is
// unchanged), and every phase's reads and atomics on it go through L1
// and L2; the histogram, the score row and the record counts stay in
// shared memory.
//
// Every float result is one add or subtract, a max or a select, so there is
// no float sum whose order could matter, and the counters are integers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 512 threads a block leave 128 registers a thread: no spills (at 1024 and 64
// registers the spilled values missed the small L1 left beside 216 KB of
// shared memory, and every phase paid for it)
constexpr int kMaxThreads = 512;
constexpr int kIpt = 2;     // consecutive items a thread takes in one scan pass
constexpr int kLanes = 4;   // most sums one scan pass carries
constexpr int kHistWindow = 256;  // histogram bins scanned with the exits
constexpr float kNeg = -1.0e30f;
constexpr float kHalfNeg = -5.0e29f;  // NEG / 2 of the plain version, in float32

// Pointer, integer and float arguments arrive as three host arrays, in the
// order of these enums (mirrored by decoder/fused_scan.py).
enum Ptr {
  P_ARC_META32, P_ENT_ARC, P_ENT_SCORE, P_ENT_AC, P_ENT_SEQ, P_F_SCORE, P_F_AC,
  P_F_SEQ, P_TRP, P_EMITTING, P_STATE_GMM, P_SCORES,
  P_IN_ARC, P_IN_SCORE, P_IN_AC, P_IN_PATH, P_IN_BEST_EMIT, P_IN_BEST_START,
  P_IN_KTH, P_IN_NORM, P_IN_OVF,
  P_OUT_ARC, P_OUT_SCORE, P_OUT_AC, P_OUT_PATH, P_OUT_BEST_EMIT,
  P_OUT_BEST_START, P_OUT_KTH, P_OUT_NORM, P_OUT_OVF,
  P_OUT_BF_SCORE, P_OUT_BF_AC, P_OUT_BF_LM, P_OUT_BF_PATH, P_OUT_BF_SEQ,
  P_OUT_BF_SRC,
  P_RECORDS, P_REC_COUNT,
  P_BF_SCORE, P_BF_AC, P_BF_LM, P_BF_PATH, P_BF_SEQ, P_BF_SRC, P_N_ACTIVE,
  P_N_CAND, P_WORKSPACE,
  N_PTR
};
enum Int {
  I_B, I_K, I_E, I_F, I_S, I_G, I_H, I_N_ARCS, I_N_ENT, I_N_FENT, I_N_BINS, I_HT,
  I_MAX_EMIT_HYPS, I_N_FRAMES, I_T_BASE, I_THREADS, I_REC_CAP, I_HMM_SMEM, I_WS_BYTES,
  N_INT
};
enum Flt { F_EMIT_WIN, F_START_WIN, F_END_WIN, F_WORD_WIN, F_HIST_MIN, F_HIST_MAX, N_FLT };

// The profiling build (-DJTPU_FS_CLOCKS, a library of its own that only
// harness/profile_decode.py loads): thread 0 of each block sums the cycles
// between the marks of a frame, per phase, and leaves them in `g_clocks`.
#ifdef JTPU_FS_CLOCKS
constexpr int kPhases = 11;  // top, A, B scan, B rest, C, D scan, D rest, E, F, G records, G rest
constexpr int kClockBlocks = 1024;  // blocks beyond these are not recorded
__device__ long long g_clocks[kClockBlocks * kPhases];
#define FS_MARK(phase)                       \
  do {                                       \
    if (tid == 0) {                          \
      const long long now = clock64();       \
      sh_clocks[phase] += now - last_clock;  \
      last_clock = now;                      \
    }                                        \
  } while (0)
#else
#define FS_MARK(phase)
#endif

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
// -0.0 and +0.0 compare equal as floats, so both map to one key
__device__ __forceinline__ unsigned score_ord(float score) {
  return (score == 0.0f) ? f2ord(0.0f) : f2ord(score);
}
// recombination key: newest generation, then best score, ties to the lowest
// index (index < 65535)
__device__ __forceinline__ unsigned long long win_key(unsigned gen, float score, int index) {
  return (static_cast<unsigned long long>(gen) << 48) |
         (static_cast<unsigned long long>(score_ord(score)) << 16) |
         (0xffffu - static_cast<unsigned>(index));
}
// best-final key: best score first, ties to the lowest position
__device__ __forceinline__ unsigned long long final_key(float score, int index) {
  return (static_cast<unsigned long long>(score_ord(score)) << 32) |
         (0xffffffffu - static_cast<unsigned>(index));
}

// the reference's histogram bin of a score (C-rounded, clamped above), or
// -1 where it counts nothing: a dead score, or one below the lowest bin
__device__ __forceinline__ int hist_bin(float s, float hist_min, float hist_max) {
  if (!(s > kHalfNeg)) return -1;
  float r = truncf(s < 0.0f ? s - 0.5f : s + 0.5f);
  r = fminf(r, hist_max);
  return r >= hist_min ? static_cast<int>(r - hist_min) : -1;
}
__device__ __forceinline__ unsigned long long warp_max_u64(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}
// inclusive prefix sums over the warp's first `width` threads of the sums
// L0..N-1 of x, all sums advanced together step by step so that their
// shuffles overlap
template <int L0, int N>
__device__ __forceinline__ void warp_inclusive_n(int (&x)[N], int lane, int width) {
  for (int d = 1; d < width; d <<= 1) {
    int y[N];
#pragma unroll
    for (int l = L0; l < N; ++l) y[l] = __shfl_up_sync(0xffffffffu, x[l], d);
#pragma unroll
    for (int l = L0; l < N; ++l) {
      if (lane >= d) x[l] += y[l];
    }
  }
}
__device__ __forceinline__ int warp_inclusive(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// find-or-insert `arc` under this frame's generation in the open-addressing
// table; an entry of another generation counts as empty. Returns the
// position. `key` = gen << abits | arc.
__device__ __forceinline__ int ht_insert(unsigned* keys, int mask, int abits, unsigned gen,
                                         int arc) {
  const unsigned key = (gen << abits) | static_cast<unsigned>(arc);
  unsigned h = static_cast<unsigned>(arc) * 2654435761u;
  h = (h ^ (h >> 15)) & mask;
  while (true) {
    const unsigned cur = *reinterpret_cast<volatile unsigned*>(&keys[h]);
    if (cur == key) return static_cast<int>(h);
    if ((cur >> abits) != gen) {
      const unsigned old = atomicCAS(&keys[h], cur, key);
      if (old == cur || old == key) return static_cast<int>(h);
      continue;  // another arc took it meanwhile: look at it again
    }
    h = (h + 1) & mask;
  }
}

// Block-wide exclusive prefix sums of NL integer lanes over items 0..n-1.
// load(i, v) fills item i's NL values (v arrives zeroed); after the sums
// store(i, excl, v) is called with the exclusive prefix of each lane. The
// first NF lanes are flags (0 or 1): their sums inside a warp come from
// ballots, not from shuffles. Every thread gets the totals. All threads of
// the block must call it; `buf` (the same in every thread) flips the
// scratch half each pass, so a pass costs one barrier. A thread takes kIpt
// consecutive items, and every load of a pass comes before any of its
// stores. A warp whose items all lie beyond n skips its own sums.
template <int NF, int NL, class Load, class Store>
__device__ __forceinline__ void block_scan(int n, int (*ws)[kLanes][32], int& buf, Load load,
                                           Store store, int (&total)[NL]) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  const unsigned le_mask = 0xffffffffu >> (31 - lane);  // lanes up to this one
#pragma unroll
  for (int l = 0; l < NL; ++l) total[l] = 0;
  for (int base = 0; base < n; base += nt * kIpt) {
    const int i0 = base + tid * kIpt;
    const bool warp_has_items = base + (tid & ~31) * kIpt < n;
    int v[kIpt][NL], s[NL], x[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) s[l] = x[l] = 0;
#pragma unroll
    for (int j = 0; j < kIpt; ++j) {
#pragma unroll
      for (int l = 0; l < NL; ++l) v[j][l] = 0;
    }
    if (warp_has_items) {
#pragma unroll
      for (int j = 0; j < kIpt; ++j) {
        if (i0 + j < n) load(i0 + j, v[j]);
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          s[l] += v[j][l];
          if (l < NF) x[l] += __popc(__ballot_sync(0xffffffffu, v[j][l] != 0) & le_mask);
        }
      }
#pragma unroll
      for (int l = NF; l < NL; ++l) x[l] = s[l];
      warp_inclusive_n<NF, NL>(x, lane, 32);
    }
    if (lane == 31) {
#pragma unroll
      for (int l = 0; l < NL; ++l) ws[buf][l][wid] = x[l];
    }
    __syncthreads();
    int run[NL], w[NL], c[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) c[l] = w[l] = (lane < nw) ? ws[buf][l][lane] : 0;
    warp_inclusive_n<0, NL>(c, lane, nw);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int before = __shfl_sync(0xffffffffu, c[l] - w[l], wid);
      run[l] = total[l] + before + x[l] - s[l];
      total[l] += __shfl_sync(0xffffffffu, c[l], nw - 1);
    }
    buf ^= 1;
#pragma unroll
    for (int j = 0; j < kIpt; ++j) {
      if (i0 + j < n) store(i0 + j, run, v[j]);
#pragma unroll
      for (int l = 0; l < NL; ++l) run[l] += v[j][l];
    }
  }
}

// one frame's block-wide reducers; two sets, used in turn, so that the set
// of the next frame is reset while this frame runs
struct Reduce {
  unsigned red_emit, red_end, red_entry;
  int n_live, n_active, n_hist, hist_bin, act;
  unsigned long long fbest;
};
struct Shared {
  Reduce r[2];
  int ws[2][kLanes][32];
};

__host__ __device__ inline size_t rup4(size_t n) { return (n + 3) & ~static_cast<size_t>(3); }

// the search state of one block, in bytes (mirrored by fused_scan.py): the
// recombination table, the frontier and work planes and the candidate planes
__host__ __device__ inline size_t search_state_bytes(int K, int E, int S, int HT) {
  return 8 * static_cast<size_t>(HT) +
         4 * (2 * static_cast<size_t>(HT) + (3 * static_cast<size_t>(S | 1) + 10) * rup4(K) +
              7 * rup4(E));
}
// dynamic shared memory of one block, in bytes (mirrored by fused_scan.py):
// the search state where it rides in shared memory, the histogram, the score
// row, the warps' record counts and, when staged, the HMM tables (hmm_words =
// H*S*(S+1), else 0)
__host__ __device__ inline size_t smem_bytes(int K, int E, int S, int G, int n_bins, int HT,
                                             int hmm_words, bool state_in_smem) {
  return (state_in_smem ? search_state_bytes(K, E, S, HT) : 0) +
         4 * (rup4(n_bins) + rup4(G) + rup4((K + 31) / 32 + 32) + rup4(hmm_words));
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int S, bool kStaged, bool kShared>
__global__ void __launch_bounds__(kMaxThreads) frame_step_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Shared sh;

  const int B = p.i[I_B], K = p.i[I_K], E = p.i[I_E], F = p.i[I_F], G = p.i[I_G];
  const int H = p.i[I_H];
  const int n_arcs = p.i[I_N_ARCS], n_ent = p.i[I_N_ENT], n_fent = p.i[I_N_FENT];
  const int n_bins = p.i[I_N_BINS], HT = p.i[I_HT], max_hyps = p.i[I_MAX_EMIT_HYPS];
  const int dead = n_arcs + 1;
  const float emit_win = p.f[F_EMIT_WIN], start_win = p.f[F_START_WIN];
  const float end_win = p.f[F_END_WIN], word_win = p.f[F_WORD_WIN];
  const float hist_min = p.f[F_HIST_MIN], hist_max = p.f[F_HIST_MAX];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  // the best-final snapshot is kept by lane 0 of the last warp, which has
  // the least to do in the per-slot phases
  const bool bf_thread = tid == nt - 32;
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  const int K4 = static_cast<int>(rup4(K)), E4 = static_cast<int>(rup4(E));
  const int G4 = static_cast<int>(rup4(G));

  // ---- carve the search state and the dynamic shared memory -------------
  // The search state (table, frontier, work and candidate planes) lies in
  // shared memory, or where it does not fit (a frontier of thousands of
  // slots) in the block's part of a workspace in device memory; the rest
  // always lies in shared memory.
  unsigned char* fbase = smem_raw;
  if (!kShared) {
    fbase = at<unsigned char>(p, P_WORKSPACE) + static_cast<size_t>(b) * p.i[I_WS_BYTES];
  }
  unsigned long long* ht_val = reinterpret_cast<unsigned long long*>(fbase);
  unsigned* ht_key = reinterpret_cast<unsigned*>(ht_val + HT);
  unsigned* ht_slot = ht_key + HT;
  // the frontier, slot-major with an odd stride: a slot's states sit at
  // constant offsets and neighbouring slots fall into different banks
  constexpr int SP = S | 1;
  float* s_score = reinterpret_cast<float*>(ht_slot + HT);  // (K, SP)
  float* s_ac = s_score + SP * K4;                          // (K, SP)
  int* s_path = reinterpret_cast<int*>(s_ac + SP * K4);     // (K, SP)
  int* s_arc = s_path + SP * K4;
  float* s_exsc = reinterpret_cast<float*>(s_arc + K4);     // exit score / ac / path
  float* s_exac = s_exsc + K4;
  int* s_expa = reinterpret_cast<int*>(s_exac + K4);
  // s_a: a slot's entry fan-out; then, compacted over the exiting slots, the
  //      inclusive entry fan-out sums; then the free-slot list
  // s_b: a slot's entry base row
  // s_c: a slot's final fan-out; then, compacted, inclusive final fan-out
  //      sum (clamped to 65535) << 16 | slot
  // s_d: a slot's final base row
  int* s_a = s_expa + K4;
  int* s_b = s_a + K4;
  int* s_c = s_b + K4;
  int* s_d = s_c + K4;
  int* s_live = s_d + K4;  // bit 0: live after this frame's emit; bit 1: no word label
  int* s_win = s_live + K4;  // the landed winner of a slot; -1 between frames
  int* c_arc = s_win + K4;                                   // candidates (E)
  float* c_score = reinterpret_cast<float*>(c_arc + E4);
  float* c_ac = c_score + E4;
  int* c_prev = reinterpret_cast<int*>(c_ac + E4);
  int* c_seq = c_prev + E4;
  int* c_src = c_seq + E4;
  int* c_h = c_src + E4;    // hash position; then the routing code of a winner
  int* s_hist = kShared ? c_h + E4 : reinterpret_cast<int*>(smem_raw);
  float* s_gmm = reinterpret_cast<float*>(s_hist + rup4(n_bins));  // the score row
  int* s_wrec = reinterpret_cast<int*>(s_gmm + G4);
  float* s_trp = reinterpret_cast<float*>(s_wrec + rup4((K + 31) / 32 + 32));  // (H, S, S)
  int* s_sg = reinterpret_cast<int*>(s_trp + H * S * S);  // (H, S) GMM id, -1 = not emitting

  const int4* arc_meta = at<const int4>(p, P_ARC_META32);
  const long long* ent_arc = at<const long long>(p, P_ENT_ARC);
  const float* ent_score = at<const float>(p, P_ENT_SCORE);
  const float* ent_ac = at<const float>(p, P_ENT_AC);
  const long long* ent_seq = at<const long long>(p, P_ENT_SEQ);
  const float* f_score = at<const float>(p, P_F_SCORE);
  const float* f_ac = at<const float>(p, P_F_AC);
  const long long* f_seq = at<const long long>(p, P_F_SEQ);
  const unsigned char* emitting = at<const unsigned char>(p, P_EMITTING);
  const long long* state_gmm = at<const long long>(p, P_STATE_GMM);
  const float* scores = at<const float>(p, P_SCORES);
  // transitions from shared memory when staged, else from device memory
  const float* trP = kStaged ? s_trp : at<const float>(p, P_TRP);

  // ---- carry in; stage the HMM tables; the first frame's scores ----------
  {
    const long long* in_arc = at<const long long>(p, P_IN_ARC);
    const float* in_score = at<const float>(p, P_IN_SCORE);
    const float* in_ac = at<const float>(p, P_IN_AC);
    const long long* in_path = at<const long long>(p, P_IN_PATH);
    for (int k = tid; k < K; k += nt) {
      const size_t row = static_cast<size_t>(b) * K + k;
      s_arc[k] = static_cast<int>(in_arc[row]);
      s_win[k] = -1;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        s_score[k * SP + s] = in_score[row * S + s];
        s_ac[k * SP + s] = in_ac[row * S + s];
        s_path[k * SP + s] = static_cast<int>(in_path[row * S + s]);
      }
    }
    if (kStaged) {
      const float* g_trp = at<const float>(p, P_TRP);
      for (int i = tid; i < H * S * S; i += nt) s_trp[i] = g_trp[i];
      for (int i = tid; i < H * S; i += nt) {
        s_sg[i] = emitting[i] ? static_cast<int>(state_gmm[i]) : -1;
      }
    }
    for (int g = tid; g < G; g += nt) s_gmm[g] = scores[static_cast<size_t>(b) * G + g];
    for (int i = tid; i < n_bins; i += nt) s_hist[i] = 0;
    if (tid == 0) {
      for (int i = 0; i < 2; ++i) {
        sh.r[i].red_emit = sh.r[i].red_end = sh.r[i].red_entry = f2ord(kNeg);
        sh.r[i].n_live = sh.r[i].n_active = sh.r[i].n_hist = sh.r[i].hist_bin = 0;
        sh.r[i].act = 0;
        sh.r[i].fbest = 0ull;
      }
    }
  }
  // per-utterance scalars: every thread keeps the same copy in registers
  float best_emit = at<const float>(p, P_IN_BEST_EMIT)[b];
  float best_start = at<const float>(p, P_IN_BEST_START)[b];
  float kth_emit = at<const float>(p, P_IN_KTH)[b];
  float norm = at<const float>(p, P_IN_NORM)[b];
  int overflow = at<const unsigned char>(p, P_IN_OVF)[b] ? 1 : 0;
  // (only `bf_thread` uses these)
  float bf_score = kNeg, bf_ac = kNeg, bf_lm = kNeg;
  int bf_path = -1, bf_seq = 0, bf_src = -1;
  // the table's generation: key = gen << abits | arc; 0 is the cleared table
  const int abits = 32 - __clz(dead);
  const unsigned gen_max = (1u << min(32 - abits, 16)) - 1u;
  unsigned gen = gen_max;  // the first frame clears
  int scan_buf = 0;
  int rec_base = 0;  // records this launch has written for the utterance
  // Slots at or above `bound` are dead and hold exactly the dead state; the
  // per-slot phases leave them alone. It is the larger of the last two
  // frames' highest active slot + 1 (see the end of phase G).
  int bound = K, act_prev = K;
  int4* records = at<int4>(p, P_RECORDS) +
                  static_cast<size_t>(b) * static_cast<size_t>(p.i[I_REC_CAP]) * 2;
#ifdef JTPU_FS_CLOCKS
  __shared__ long long sh_clocks[kPhases];
  long long last_clock = 0;
  if (tid == 0) {
    for (int i = 0; i < kPhases; ++i) sh_clocks[i] = 0;
    last_clock = clock64();
  }
#endif
  __syncthreads();

  for (int f = 0; f < p.i[I_N_FRAMES]; ++f) {
    const size_t row_tb = static_cast<size_t>(f) * B + b;
    const int t = p.i[I_T_BASE] + f;
    Reduce& red = sh.r[f & 1];
    const int bound_r = (bound + 31) & ~31;  // whole warps take part

    // ---- frame scalars ----------------------------------------------------
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
    if (++gen > gen_max) {
      for (int i = tid; i < HT; i += nt) {
        ht_val[i] = 0ull;
        ht_key[i] = 0u;
        ht_slot[i] = 0xffffffffu;
      }
      gen = 1;
      __syncthreads();
    }
    FS_MARK(0);

    // ---- A. internal propagation, emit beam, histogram counts, exit ----
    for (int k = tid; k < bound_r; k += nt) {
      float m_emit = kNeg, m_end = kNeg;
      bool live = false;
      unsigned n_counted = 0;
      if (k < bound) {
        const int arc = s_arc[k];
        const bool is_dead = arc > n_arcs;
        // row: hmm, no-word-label flag, entry base, entry fan | final base,
        // final fan, 0, 0
        const int4* mrow = arc_meta + static_cast<size_t>(min(arc, dead)) * 2;
        const int4 m0 = __ldg(mrow), m1 = __ldg(mrow + 1);
        float sc[S], ac[S];
        int pa[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          sc[s] = s_score[k * SP + s];
          ac[s] = s_ac[k * SP + s];
          pa[s] = s_path[k * SP + s];
        }
        if (start_win > 0.0f && sc[0] < start_thresh) sc[0] = kNeg;
        const int hmm = m0.x;
        float tr[S * S];
#pragma unroll
        for (int i = 0; i < S * S; ++i) tr[i] = is_dead ? kNeg : trP[hmm * S * S + i];
        float exit_best = 0.0f, exit_ac = 0.0f;
        int exit_pa = -1;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          // first max over predecessors i of sc[i] + trP[i, j]
          float w = tr[j];
          float best = sc[0] + w, bac = ac[0] + w;
          int bpa = pa[0];
#pragma unroll
          for (int i = 1; i < S; ++i) {
            w = tr[i * S + j];
            const float m = sc[i] + w;
            if (m > best) {
              best = m;
              bac = ac[i] + w;
              bpa = pa[i];
            }
          }
          const float ns = best - normalise;
          int gm;
          if (kStaged) {
            gm = s_sg[hmm * S + j];
          } else {
            gm = emitting[hmm * S + j] ? static_cast<int>(state_gmm[hmm * S + j]) : -1;
          }
          const bool pass = gm >= 0 && ns > emit_thresh && best > kHalfNeg;
          const float outp = s_gmm[max(gm, 0)];
          const float s2 = pass ? ns + outp : kNeg;
          const float a2 = pass ? bac + outp : kNeg;
          const int p2 = pass ? bpa : -1;
          s_score[k * SP + j] = s2;
          s_ac[k * SP + j] = a2;
          s_path[k * SP + j] = p2;
          m_emit = fmaxf(m_emit, s2);
          if (j < S - 1 && s2 > kHalfNeg) live = true;
          if (max_hyps > 0) {
            const int bin = hist_bin(s2, hist_min, hist_max);
            if (bin >= 0) {
              atomicAdd(&s_hist[bin], 1);
              ++n_counted;
            }
          }
          // exit state: first max over j of s2[j] + trP[j, S-1]
          const float we = tr[j * S + (S - 1)];
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
        s_live[k] = (live ? 1 : 0) | (m0.y ? 2 : 0);
        s_b[k] = m0.z;
        s_a[k] = m0.w;
        s_d[k] = m1.x;
        s_c[k] = m1.y;
      }
      const unsigned o_emit = __reduce_max_sync(0xffffffffu, f2ord(m_emit));
      const unsigned o_end = __reduce_max_sync(0xffffffffu, f2ord(m_end));
      const unsigned n_l = __popc(__ballot_sync(0xffffffffu, live));
      if (max_hyps > 0) n_counted = __reduce_add_sync(0xffffffffu, n_counted);
      if (lane == 0) {
        atomicMax(&red.red_emit, o_emit);
        atomicMax(&red.red_end, o_end);
        if (n_l) atomicAdd(&red.n_live, static_cast<int>(n_l));
        if (n_counted) atomicAdd(&red.n_hist, static_cast<int>(n_counted));
      }
    }
    __syncthreads();  // 1
    // phase A was the score row's only reader: the next frame's row comes
    // into the same buffer while the rest of this frame computes (waited
    // for before barrier 8)
    if (f + 1 < p.i[I_N_FRAMES]) {
      const float* next = scores + (row_tb + B) * G;
      for (int g = tid; g < G; g += nt) cp_async4(s_gmm + g, next + g);
    }
    FS_MARK(1);

    // ---- B. exit beams; one scan: exits, both fan-outs, the histogram ----
    if (tid == 0) {
      // the other set's last reader was thread 0 itself, a frame ago
      Reduce& nx = sh.r[(f + 1) & 1];
      nx.red_emit = nx.red_end = nx.red_entry = f2ord(kNeg);
      nx.n_live = nx.n_active = nx.n_hist = nx.act = 0;
      nx.fbest = 0ull;
    }
    const float best_emit_new = ord2f(red.red_emit);
    const float best_end = ord2f(red.red_end);
    const int n_live = red.n_live;
    const float end_thresh = end_win > 0.0f ? best_end - end_win : kNeg;
    const float word_thresh = word_win > 0.0f ? best_end - word_win : kNeg;
    // The threshold is wanted only when more than max_hyps states were
    // counted. The counts are scanned from the bin of the best score down,
    // kHistWindow bins with the exits; further down only if the sum has
    // not reached max_hyps by then.
    const bool hist_binds = max_hyps > 0 && red.n_hist > max_hyps;
    const int bin_hi = hist_binds ? hist_bin(best_emit_new, hist_min, hist_max) : -1;
    const int n_hw = min(bin_hi + 1, kHistWindow);
    int tot1[4];  // exiting slots, entry rows, final rows, histogram count
    block_scan<1, 4>(
        max(bound, n_hw), sh.ws, scan_buf,
        [&](int i, int* v) {
          if (i < bound) {
            // all five loads at once, then the selects
            const float ex = s_exsc[i];
            const int flags = s_live[i], arc = s_arc[i], e_fan = s_a[i], f_fan = s_c[i];
            const float thr = (flags & 2) ? end_thresh : word_thresh;
            const bool exits = ex > kHalfNeg && ex > thr && arc <= n_arcs;
            v[0] = exits ? 1 : 0;
            v[1] = exits ? e_fan : 0;
            v[2] = exits ? f_fan : 0;
          }
          if (i < n_hw) v[3] = s_hist[bin_hi - i];
        },
        [&](int i, const int* excl, const int* v) {
          if (v[0]) {
            s_a[excl[0]] = excl[1] + v[1];
            s_c[excl[0]] = (min(excl[2] + v[2], 0xffff) << 16) | i;
          }
          if (i < n_hw && excl[3] < max_hyps && excl[3] + v[3] >= max_hyps) {
            red.hist_bin = bin_hi - i;
          }
        },
        tot1);
    const int n_x = tot1[0], total = tot1[1], ftotal = tot1[2];
    FS_MARK(2);
    for (int seen = n_hw, cum = tot1[3]; hist_binds && cum < max_hyps && seen <= bin_hi;) {
      const int n_more = min(bin_hi + 1 - seen, nt * kIpt);
      int tot[1];
      block_scan<0, 1>(
          n_more, sh.ws, scan_buf, [&](int i, int* v) { v[0] = s_hist[bin_hi - seen - i]; },
          [&](int i, const int* excl, const int* v) {
            if (cum + excl[0] < max_hyps && cum + excl[0] + v[0] >= max_hyps) {
              red.hist_bin = bin_hi - seen - i;
            }
          },
          tot);
      cum += tot[0];
      seen += n_more;
    }
    __syncthreads();  // 3 (the scan's own was 2)
    FS_MARK(3);

    // ---- C. closure expansion into candidates; finals; hash inserts ------
    const int n_c = min(total, E);
    // candidate e: its exiting slot and the row of the entry tables
    auto cand_row = [&](int e, int& k) {
      int lo_j = 0, hi_j = n_x;
      while (lo_j < hi_j) {
        const int mid = (lo_j + hi_j) >> 1;
        if (s_a[mid] > e) hi_j = mid; else lo_j = mid + 1;
      }
      k = s_c[lo_j] & 0xffff;
      const int lo = lo_j ? s_a[lo_j - 1] : 0;
      const long long row = static_cast<long long>(s_b[k]) + (e - lo);
      return row < 0 ? 0 : (row > n_ent - 1 ? n_ent - 1 : row);
    };
    auto cand_finish = [&](int e, int k, float w_sc, float w_ac, long long w_arc,
                           long long w_seq) {
      const float csc = s_exsc[k] + w_sc;
      c_ac[e] = s_exac[k] + w_ac;
      c_prev[e] = s_expa[k];
      c_seq[e] = static_cast<int>(w_seq);
      c_src[e] = s_arc[k];
      int h = -1;
      float g_score = kNeg;
      int g_arc = dead;
      if (csc > kHalfNeg) {
        g_score = csc;
        g_arc = static_cast<int>(w_arc);
        h = ht_insert(ht_key, HT - 1, abits, gen, g_arc);
        atomicMax(&ht_val[h], win_key(gen, csc, e));
      }
      c_score[e] = g_score;
      c_arc[e] = g_arc;
      c_h[e] = h;
    };
    // the position q of the final list: its exiting slot and table row
    auto final_at = [&](int q, int& k) {
      int lo_j = 0, hi_j = n_x;
      while (lo_j < hi_j) {
        const int mid = (lo_j + hi_j) >> 1;
        if ((s_c[mid] >> 16) > q) hi_j = mid; else lo_j = mid + 1;
      }
      k = s_c[lo_j] & 0xffff;
      const int lo = lo_j ? (s_c[lo_j - 1] >> 16) : 0;
      const long long row = static_cast<long long>(s_d[k]) + (q - lo);
      return row < 0 ? 0 : (row > n_fent - 1 ? n_fent - 1 : row);
    };
    {
      // A thread's first candidate and first final position ask for their
      // table rows before the live slots go into the table, so that the
      // device-memory latency runs beside the shared-memory work.
      const int n_f = min(ftotal, F);
      int k0 = 0, k1 = 0, kf = 0;
      float w_sc0 = 0.0f, w_ac0 = 0.0f, w_sc1 = 0.0f, w_ac1 = 0.0f, wf_sc = 0.0f;
      long long w_arc0 = 0, w_seq0 = 0, w_arc1 = 0, w_seq1 = 0;
      const int e1 = tid + nt;  // a thread's first two candidates are in flight together
      if (tid < n_c) {
        const long long row = cand_row(tid, k0);
        w_sc0 = __ldg(ent_score + row);
        w_ac0 = __ldg(ent_ac + row);
        w_arc0 = __ldg(ent_arc + row);
        w_seq0 = __ldg(ent_seq + row);
      }
      if (e1 < n_c) {
        const long long row = cand_row(e1, k1);
        w_sc1 = __ldg(ent_score + row);
        w_ac1 = __ldg(ent_ac + row);
        w_arc1 = __ldg(ent_arc + row);
        w_seq1 = __ldg(ent_seq + row);
      }
      if (tid < n_f) wf_sc = __ldg(f_score + final_at(tid, kf));
      for (int k = tid; k < bound; k += nt) {
        if (s_live[k] & 1) {
          atomicMin(&ht_slot[ht_insert(ht_key, HT - 1, abits, gen, s_arc[k])],
                    ((0xffffu - gen) << 16) | static_cast<unsigned>(k));
        }
      }
      if (tid < n_c) cand_finish(tid, k0, w_sc0, w_ac0, w_arc0, w_seq0);
      if (e1 < n_c) cand_finish(e1, k1, w_sc1, w_ac1, w_arc1, w_seq1);
      for (int e = e1 + nt; e < n_c; e += nt) {
        int k;
        const long long row = cand_row(e, k);
        cand_finish(e, k, __ldg(ent_score + row), __ldg(ent_ac + row), __ldg(ent_arc + row),
                    __ldg(ent_seq + row));
      }
      // this frame's best final-state reach: first max over the F positions
      if (n_f > (tid & ~31)) {
        unsigned long long fkey = tid < n_f ? final_key(s_exsc[kf] + wf_sc, tid) : 0ull;
        for (int q = tid + nt; q < n_f; q += nt) {
          int k;
          const long long row = final_at(q, k);
          const unsigned long long key = final_key(s_exsc[k] + __ldg(f_score + row), q);
          fkey = key > fkey ? key : fkey;
        }
        fkey = warp_max_u64(fkey);
        if (lane == 0 && fkey) atomicMax(&red.fbest, fkey);
      }
    }
    __syncthreads();  // 4
    FS_MARK(4);

    // one thread asks for the snapshot's table row; the loads are in flight
    // through phases D to F and are used after barrier 7
    float bfw_sc = 0.0f, bfw_ac = 0.0f, bfx_sc = kNeg, bfx_ac = kNeg;
    long long bfw_seq = 0;
    int bfx_pa = -1, bfx_src = -1;
    bool bf_any = false;
    if (bf_thread) {
      const unsigned long long fkey = red.fbest;
      if (fkey) {
        const int q = static_cast<int>(0xffffffffu - static_cast<unsigned>(fkey));
        int k;
        const long long row = final_at(q, k);
        bfw_sc = __ldg(f_score + row);
        bfw_ac = __ldg(f_ac + row);
        bfw_seq = __ldg(f_seq + row);
        bfx_sc = s_exsc[k];
        bfx_ac = s_exac[k];
        bfx_pa = s_expa[k];
        bfx_src = s_arc[k];
        bf_any = true;
      }
    }

    // ---- D. winners' routing codes; one scan: new winners, holes ----------
    // code >= 0: the arc's live slot; -1: not a winner; <= -2: needs a new
    // slot, rank -2 - code among such winners in candidate order. The free
    // slots in slot order are the holes below `bound`, then bound, bound+1..
    int tot2[2];
    block_scan<2, 2>(
        max(n_c, bound), sh.ws, scan_buf,
        [&](int i, int* v) {
          if (i < n_c) {
            const int h = c_h[i];
            int code = -1;
            // the table's words were last written by atomics: in device
            // memory they are read from L2, where the atomics landed
            if (h >= 0 && (static_cast<unsigned>(kShared ? ht_val[h] : __ldcg(ht_val + h)) &
                           0xffffu) == 0xffffu - static_cast<unsigned>(i)) {
              const unsigned sl = kShared ? ht_slot[h] : __ldcg(ht_slot + h);
              code = (sl >> 16) == 0xffffu - gen ? static_cast<int>(sl & 0xffffu) : -2;
            }
            c_h[i] = code;
            v[0] = code == -2 ? 1 : 0;
          }
          if (i < bound) v[1] = (s_live[i] & 1) ? 0 : 1;
        },
        [&](int i, const int* excl, const int* v) {
          if (v[0]) c_h[i] = -2 - excl[0];
          if (v[1]) s_a[excl[1]] = i;
        },
        tot2);
    const int n_new = tot2[0], n_holes = tot2[1];
    FS_MARK(5);
    const int n_free = K - n_live;
    // slots below `top` may hold something after this frame
    const int top = bound + max(0, min(n_new, n_free) - n_holes);
    const int top_r = (top + 31) & ~31;
    __syncthreads();  // 6 (the scan's own was 5)
    FS_MARK(6);

    // ---- E. winners take their slots -------------------------------------
    for (int e = tid; e < ((n_c + 31) & ~31); e += nt) {
      float m_entry = kNeg;
      if (e < n_c) {
        const int code = c_h[e];
        int slot = -1;
        if (code >= 0) {
          slot = code;
        } else if (code <= -2 && -2 - code < n_free) {
          const int r = -2 - code;
          slot = r < n_holes ? s_a[r] : bound + (r - n_holes);
        }
        if (slot >= 0) {
          s_win[slot] = e;
          m_entry = c_score[e];
        }
      }
      const unsigned o_entry = __reduce_max_sync(0xffffffffu, f2ord(m_entry));
      if (lane == 0) atomicMax(&red.red_entry, o_entry);
    }
    __syncthreads();  // 7
    FS_MARK(7);

    // ---- F. insertion; count this frame's records by warp -----------------
    for (int k = tid; k < top_r; k += nt) {
      bool active = false, has_rec = false;
      if (k < top) {
        const int e = s_win[k];
        const bool live = (s_live[k] & 1) != 0;
        if (max_hyps > 0 && k < bound) {
          // clear the bins this slot counted into
#pragma unroll
          for (int j = 0; j < S; ++j) {
            const int bin = hist_bin(s_score[k * SP + j], hist_min, hist_max);
            if (bin >= 0) s_hist[bin] = 0;
          }
        }
        if (e >= 0) {
          const int l_seq = c_seq[e];
          s_score[k * SP] = c_score[e];
          s_ac[k * SP] = c_ac[e];
          s_path[k * SP] = l_seq != 0 ? t * K + k : c_prev[e];
          s_arc[k] = c_arc[e];
          has_rec = l_seq != 0;
        } else {
          s_score[k * SP] = kNeg;
          s_ac[k * SP] = kNeg;
          s_path[k * SP] = -1;
          if (!live) s_arc[k] = dead;
        }
        active = live || e >= 0;
      }
      const unsigned n_r = __popc(__ballot_sync(0xffffffffu, has_rec));
      const unsigned act = __ballot_sync(0xffffffffu, active);
      if (lane == 0) {
        s_wrec[k >> 5] = static_cast<int>(n_r);
        if (act) {
          atomicAdd(&red.n_active, __popc(act));
          atomicMax(&red.act, k + 32 - __clz(act));  // one past the highest active slot
        }
      }
    }
    const float best_entry = ord2f(red.red_entry);
    best_emit = fmaxf(best_emit_new, best_entry);
    best_start = best_entry;
    overflow |= (total > E) | (n_new > n_free) | (ftotal > F);
    if (bf_thread) {
      bf_score = bf_ac = bf_lm = kNeg;
      bf_path = -1;
      bf_seq = 0;
      bf_src = -1;
      const float s_i = bfx_sc + bfw_sc;
      if (bf_any && s_i > kNeg) {
        const float a_i = bfx_ac + bfw_ac;
        bf_score = s_i;
        bf_ac = a_i;
        bf_lm = (s_i - a_i) + norm;
        bf_path = bfx_pa;
        bf_seq = static_cast<int>(bfw_seq);
        bf_src = bfx_src;
      }
    }
    cp_async_wait_all();
    __syncthreads();  // 8
    FS_MARK(8);

    // ---- G. this frame's records, in slot order ---------------------------
    // A slot belongs to the same thread here and in phase A of the next
    // frame, and the candidate planes stand until its phase C, so no
    // barrier is needed after this.
    if (max_hyps > 0) {
      kth_emit = hist_binds ? (hist_min + static_cast<float>(red.hist_bin)) - 0.5f
                            : hist_min - 0.5f;
    }
    {
      const int n_wrec = top_r >> 5;  // the warps' slot ranges that counted
      // up to 32 ranges (K <= 1024): one scan of the counts serves every chunk
      const int w0 = lane < n_wrec ? s_wrec[lane] : 0;
      const int c0 = warp_inclusive(w0, lane);
      int n_rec = __shfl_sync(0xffffffffu, c0, 31);
      for (int g = 32; g < n_wrec; g += 32) {
        n_rec += __reduce_add_sync(0xffffffffu, (g + lane < n_wrec) ? s_wrec[g + lane] : 0);
      }
      int chunk = 0;
      for (int k = tid; k < top_r; k += nt, ++chunk) {
        const int q = chunk * nw + wid;  // this warp's slot range
        // records of the slot ranges below q
        int mine = __shfl_sync(0xffffffffu, q < 32 ? c0 - w0 : c0, q < 32 ? q : 31);
        for (int g = 32; g <= q; g += 32) {
          const int w = (g + lane < n_wrec) ? s_wrec[g + lane] : 0;
          const int c = warp_inclusive(w, lane);
          mine += __shfl_sync(0xffffffffu, q < g + 32 ? c - w : c, q < g + 32 ? q - g : 31);
        }
        const int e = k < top ? s_win[k] : -1;
        const bool has_rec = e >= 0 && c_seq[e] != 0;
        const unsigned ball = __ballot_sync(0xffffffffu, has_rec);
        if (e >= 0) s_win[k] = -1;  // the plane is all -1 between frames
        if (has_rec) {
          const int pos = rec_base + mine + __popc(ball & ((1u << lane) - 1u));
          const float l_score = c_score[e], l_ac = c_ac[e];
          int4* out = records + static_cast<size_t>(pos) * 2;
          out[0] = make_int4(t * K + k, c_prev[e], c_seq[e], __float_as_int(l_score));
          out[1] = make_int4(__float_as_int(l_ac), __float_as_int((l_score - l_ac) + norm),
                             c_src[e], c_arc[e]);
        }
      }
      rec_base += n_rec;
    }
    FS_MARK(9);
    // Slots at or above `bound` are dead and hold exactly the dead state, so
    // the next frame leaves them alone. A slot that died in this frame
    // still holds its last states: it lies below this frame's `act_prev`
    // and is propagated once more, which writes the dead state.
    {
      const int act = red.act;
      bound = max(act, act_prev);
      act_prev = act;
    }

    if (bf_thread) {
      at<float>(p, P_BF_SCORE)[row_tb] = bf_score;
      at<float>(p, P_BF_AC)[row_tb] = bf_ac;
      at<float>(p, P_BF_LM)[row_tb] = bf_lm;
      at<int>(p, P_BF_PATH)[row_tb] = bf_path;
      at<int>(p, P_BF_SEQ)[row_tb] = bf_seq;
      at<int>(p, P_BF_SRC)[row_tb] = bf_src;
      at<int>(p, P_N_ACTIVE)[row_tb] = red.n_active;
      at<int>(p, P_N_CAND)[row_tb] = total;
      at<int>(p, P_REC_COUNT)[row_tb] = rec_base;
    }
    FS_MARK(10);
  }
#ifdef JTPU_FS_CLOCKS
  if (tid == 0 && b < kClockBlocks) {
    for (int i = 0; i < kPhases; ++i) g_clocks[b * kPhases + i] = sh_clocks[i];
  }
#endif

  // ---- carry out (a slot is written and read by the same thread) ----------
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
        out_score[row * S + s] = s_score[k * SP + s];
        out_ac[row * S + s] = s_ac[k * SP + s];
        out_path[row * S + s] = s_path[k * SP + s];
      }
    }
    if (bf_thread) {
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

template <int S, bool kStaged, bool kShared>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  // the opt-in to more than 48 KB is set once per instantiation, device and
  // size
  constexpr int kMaxDevices = 64;
  static size_t allowed_on[kMaxDevices];
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) return -1;
  size_t& allowed = allowed_on[device];
  if (smem > 48 * 1024 && smem > allowed) {
    const cudaError_t rc = cudaFuncSetAttribute(
        frame_step_kernel<S, kStaged, kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    allowed = smem;
  }
  frame_step_kernel<S, kStaged, kShared><<<p.i[I_B], p.i[I_THREADS], smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- the best-path walk ----------------------------------------------------
// After a launch of the frame step from frame 0, `path_walk_kernel` reads
// back, for each utterance, only what its words need: one warp an
// utterance writes a header and the records of its best path, so that the
// host copies a few KB instead of the whole record arena and looks nothing
// up. Its plain version is `fused_scan.walk_paths_plain`, held to it bit
// for bit. It replaces no TPU kernel: the JAX package copies the records
// and traces back on the host (`pallas_scan.assemble_results`), as the
// port did before it. What bounds it is latency, not bytes: a path is a
// chain of dependent reads (about 20 records an utterance at the 20k
// task, each a window lookup and a 32-byte row), so a warp takes one
// utterance, every utterance of the wave at once, and each step costs a
// few dependent loads.
//
// The header (kHeadWords int32 words, enum Head): the best final at the
// true length n (the (T, B) snapshot at frame n - 1 where 0 < n < T, else
// the carry's), the overflow flag, the path's length, the walk's status
// (0: it reached prev = -1; 1: a record was missing, its id in
// H_MISSING; 2: it passed T + 1 records), the max of `n_active` and of
// `n_cand` and the sum of `n_active` over the first n frames (all T where
// n is outside (0, T)), and the launch's records landed and sums of
// `n_active` and `n_cand` over every frame (the span counters).
//
// A path row is the record's eight words with the id replaced by its
// frame: {frame, prev, seq, score, ac, lm, src, arc}; an init record
// (id in [-K, 0), from `rec0`) has frame 0. Rows go to (T + 1, B, 8) in
// walk order (the best final's record first): row r of every utterance
// is contiguous, so the first `copy_rows` rows of the wave are one range
// (zero past a path's end) and the rest of the longest path a second.
//
// The arena of an utterance is in ascending id t*K + slot, and rec_count
// is the running count at the end of each frame, so record pid lies among
// rows [rec_count[t - 1], rec_count[t]) with t = pid / K: the warp
// narrows that window 32-fold a round (each lane samples one id, a ballot
// finds the interval), then finds the id among the last 32 rows.
enum WalkPtr {
  Q_RECORDS, Q_REC_COUNT, Q_BF_SCORE, Q_BF_AC, Q_BF_LM, Q_BF_PATH, Q_BF_SEQ, Q_BF_SRC,
  Q_N_ACTIVE, Q_N_CAND, Q_FIN_SCORE, Q_FIN_AC, Q_FIN_LM, Q_FIN_PATH, Q_FIN_SEQ,
  Q_FIN_SRC, Q_OVERFLOW, Q_REC0, Q_LENGTHS, Q_OUT,
  N_QPTR
};
enum WalkInt { J_B, J_K, J_T, J_REC_CAP, J_COPY_ROWS, N_JINT };
// The header's words in order, once: the enum below and the names the
// library exports (`jtpu_walk_head_names`, which the wrapper holds its
// layout to) are both made from this list.
#define JTPU_WALK_HEAD(X)                                                          \
  X(SCORE, score) X(AC, ac) X(LM, lm) X(PATH, path) X(SEQ, seq) X(SRC, src)       \
  X(OVERFLOW, overflow) X(LEN, len) X(STATUS, status) X(MISSING, missing)         \
  X(MAX_ACTIVE, max_active) X(MAX_CAND, max_cand) X(SUM_ACTIVE, sum_active)       \
  X(RECORDS, records) X(ACTIVE_ALL, active_all) X(PAD, pad)                       \
  X(CAND_ALL_LO, cand_all_lo) X(CAND_ALL_HI, cand_all_hi)
enum Head {
#define JTPU_HEAD_ENUM(e, s) H_##e,
  JTPU_WALK_HEAD(JTPU_HEAD_ENUM)
#undef JTPU_HEAD_ENUM
  N_HEAD
};
constexpr int kHeadWords = 20;  // N_HEAD rounded up: rows stay 16-byte aligned
static_assert(N_HEAD <= kHeadWords && kHeadWords % 4 == 0, "header words");
constexpr int kWalkWarps = 4;   // utterances a block

struct WalkParams {
  const void* ptr[N_QPTR];
  int i[N_JINT];
};

__global__ void __launch_bounds__(32 * kWalkWarps) path_walk_kernel(const WalkParams p) {
  constexpr unsigned kAll = 0xffffffffu;
  const int B = p.i[J_B], K = p.i[J_K], T = p.i[J_T];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWalkWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const int* rec_count = static_cast<const int*>(p.ptr[Q_REC_COUNT]);
  const int* n_active = static_cast<const int*>(p.ptr[Q_N_ACTIVE]);
  const int* n_cand = static_cast<const int*>(p.ptr[Q_N_CAND]);
  const int n = static_cast<const int*>(p.ptr[Q_LENGTHS])[b];
  const int te = (n > 0 && n < T) ? n : T;

  // counters over the true length and over every frame
  int sum_act = 0, max_act = 0, max_cand = 0, act_all = 0;
  long long cand_all = 0;
  for (int t = lane; t < T; t += 32) {
    const int a = n_active[static_cast<size_t>(t) * B + b];
    const int c = n_cand[static_cast<size_t>(t) * B + b];
    act_all += a;
    cand_all += c;
    if (t < te) {
      sum_act += a;
      max_act = max(max_act, a);
      max_cand = max(max_cand, c);
    }
  }
  sum_act = __reduce_add_sync(kAll, sum_act);
  act_all = __reduce_add_sync(kAll, act_all);
  max_act = __reduce_max_sync(kAll, max_act);
  max_cand = __reduce_max_sync(kAll, max_cand);
  for (int o = 16; o > 0; o >>= 1) cand_all += __shfl_xor_sync(kAll, cand_all, o);

  // the best final at the true length
  int bf[6];
  if (te < T) {
    const size_t row = static_cast<size_t>(te - 1) * B + b;
#pragma unroll
    for (int f = 0; f < 6; ++f) bf[f] = static_cast<const int*>(p.ptr[Q_BF_SCORE + f])[row];
  } else {
#pragma unroll
    for (int f = 0; f < 3; ++f) bf[f] = static_cast<const int*>(p.ptr[Q_FIN_SCORE + f])[b];
#pragma unroll
    for (int f = 3; f < 6; ++f) {
      bf[f] = static_cast<int>(static_cast<const long long*>(p.ptr[Q_FIN_SCORE + f])[b]);
    }
  }

  // the walk: lane w < 8 carries word w of the current row
  int* out = static_cast<int*>(const_cast<void*>(p.ptr[Q_OUT]));
  int* rows = out + static_cast<size_t>(B) * kHeadWords;
  const int* rec = static_cast<const int*>(p.ptr[Q_RECORDS]) +
                   static_cast<size_t>(b) * p.i[J_REC_CAP] * 8;
  const int* rec0 = static_cast<const int*>(p.ptr[Q_REC0]) + static_cast<size_t>(b) * K * 8;
  int len = 0, status = 0, missing = 0;
  // the host's empty test, `score <= NEG / 2` in double
  if (!(static_cast<double>(__int_as_float(bf[H_SCORE])) <= -5.0e29)) {
    int pid = bf[H_PATH];
    while (pid != -1) {
      if (len == T + 1) {
        status = 2;
        break;
      }
      int word = 0;
      bool found = false;
      if (pid >= 0) {
        const int t = pid / K;
        if (t < T) {
          int lo = t > 0 ? rec_count[static_cast<size_t>(t - 1) * B + b] : 0;
          int hi = rec_count[static_cast<size_t>(t) * B + b];
          while (hi - lo > 32) {
            const long long span = hi - lo;
            const int pos = lo + static_cast<int>(lane * span / 32);
            const unsigned le = __ballot_sync(kAll, rec[static_cast<size_t>(pos) * 8] <= pid);
            if (le == 0) {
              hi = lo;  // below the window's first id
              break;
            }
            const int j = 31 - __clz(le);
            const int nlo = lo + static_cast<int>(j * span / 32);
            hi = j == 31 ? hi : lo + static_cast<int>((j + 1) * span / 32);
            lo = nlo;
          }
          const bool hit = lane < hi - lo && rec[static_cast<size_t>(lo + lane) * 8] == pid;
          const unsigned hits = __ballot_sync(kAll, hit);
          if (hits != 0) {
            found = true;
            const size_t i = static_cast<size_t>(lo + __ffs(hits) - 1);
            if (lane < 8) word = lane == 0 ? t : rec[i * 8 + lane];
          }
        }
      } else if (pid >= -K) {
        found = true;
        if (lane < 8) word = rec0[static_cast<size_t>(pid + K) * 8 + lane];
      }
      if (!found) {
        status = 1;
        missing = pid;
        break;
      }
      if (lane < 8) rows[(static_cast<size_t>(len) * B + b) * 8 + lane] = word;
      ++len;
      pid = __shfl_sync(kAll, word, 1);
    }
  }
  // the copied rows past the path's end read zero
  for (int r = len; r < p.i[J_COPY_ROWS]; ++r) {
    if (lane < 8) rows[(static_cast<size_t>(r) * B + b) * 8 + lane] = 0;
  }

  if (lane < kHeadWords) {
    int v = 0;
    switch (lane) {
      case H_SCORE: case H_AC: case H_LM: case H_PATH: case H_SEQ: case H_SRC:
        v = bf[0];
#pragma unroll
        for (int f = 1; f < 6; ++f) v = lane == f ? bf[f] : v;
        break;
      case H_OVERFLOW: v = static_cast<const unsigned char*>(p.ptr[Q_OVERFLOW])[b] ? 1 : 0; break;
      case H_LEN: v = len; break;
      case H_STATUS: v = status; break;
      case H_MISSING: v = missing; break;
      case H_MAX_ACTIVE: v = max_act; break;
      case H_MAX_CAND: v = max_cand; break;
      case H_SUM_ACTIVE: v = sum_act; break;
      case H_RECORDS: v = rec_count[static_cast<size_t>(T - 1) * B + b]; break;
      case H_ACTIVE_ALL: v = act_all; break;
      case H_CAND_ALL_LO: v = static_cast<int>(cand_all & 0xffffffffll); break;
      case H_CAND_ALL_HI: v = static_cast<int>(cand_all >> 32); break;
      default: break;
    }
    out[static_cast<size_t>(b) * kHeadWords + lane] = v;
  }
}

}  // namespace

// Dynamic shared memory one block takes, in bytes.
extern "C" long long jtpu_frame_step_smem_bytes(int K, int E, int S, int G, int n_bins, int HT,
                                                int hmm_words, int state_in_smem) {
  return static_cast<long long>(
      smem_bytes(K, E, S, G, n_bins, HT, hmm_words, state_in_smem != 0));
}

#ifdef JTPU_FS_CLOCKS
// The profiling build's cycles: `out` takes n_blocks rows of n_phases sums
// (host memory). Returns the number of phases, or -1 on a failed copy.
extern "C" int jtpu_frame_step_read_clocks(long long* out, int n_blocks) {
  if (n_blocks < 0 || n_blocks > kClockBlocks) return -1;
  const cudaError_t rc =
      cudaMemcpyFromSymbol(out, g_clocks, sizeof(long long) * n_blocks * kPhases);
  return rc == cudaSuccess ? kPhases : -1;
}
#endif

extern "C" int jtpu_frame_step_arg_counts(int* n_ptr, int* n_int, int* n_flt) {
  *n_ptr = N_PTR;
  *n_int = N_INT;
  *n_flt = N_FLT;
  return 0;
}

// Launches on `stream` one block per utterance over ints[I_N_FRAMES] frames.
// Returns cudaGetLastError() (0 = launched), or -1 for an unsupported S,
// thread count or budget (K, E, F must stay below 65535: slots, candidate
// and final positions share 32-bit words with the table's generation).
extern "C" int jtpu_frame_step(const void* const* ptrs, const int* ints, const float* flts,
                               void* stream) {
  Params p;
  for (int i = 0; i < N_PTR; ++i) p.ptr[i] = ptrs[i];
  for (int i = 0; i < N_INT; ++i) p.i[i] = ints[i];
  for (int i = 0; i < N_FLT; ++i) p.f[i] = flts[i];
  if (p.i[I_B] <= 0 || p.i[I_N_FRAMES] <= 0) return 0;
  const int nt = p.i[I_THREADS];
  if (nt < 32 || nt > kMaxThreads || nt % 32) return -1;
  if (p.i[I_K] >= 0xffff || p.i[I_E] >= 0xffff || p.i[I_F] >= 0xffff) return -1;
  // the search state in shared memory, or (ws_bytes > 0) in a workspace of
  // B * ws_bytes bytes of device memory that holds it
  const bool shared = p.i[I_WS_BYTES] == 0;
  if (!shared && (p.ptr[P_WORKSPACE] == nullptr || p.i[I_WS_BYTES] % 16 ||
                  static_cast<size_t>(p.i[I_WS_BYTES]) <
                      search_state_bytes(p.i[I_K], p.i[I_E], p.i[I_S], p.i[I_HT]))) {
    return -1;
  }
  const size_t smem =
      smem_bytes(p.i[I_K], p.i[I_E], p.i[I_S], p.i[I_G], p.i[I_N_BINS], p.i[I_HT],
                 p.i[I_HMM_SMEM] ? p.i[I_H] * p.i[I_S] * (p.i[I_S] + 1) : 0, shared);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool staged = p.i[I_HMM_SMEM] != 0;
  switch (p.i[I_S]) {
#define JTPU_FS_CASE(n)                                                                    \
    case n:                                                                                \
      if (shared) return staged ? launch<n, true, true>(p, smem, s)                        \
                                : launch<n, false, true>(p, smem, s);                      \
      return staged ? launch<n, true, false>(p, smem, s) : launch<n, false, false>(p, smem, s);
    JTPU_FS_CASE(2) JTPU_FS_CASE(3) JTPU_FS_CASE(4) JTPU_FS_CASE(5)
    JTPU_FS_CASE(6) JTPU_FS_CASE(7) JTPU_FS_CASE(8)
#undef JTPU_FS_CASE
    default: return -1;
  }
}

// Launches the best-path walk on `stream`: one warp an utterance, kWalkWarps
// utterances a block. `n_ptr` and `n_int` are the caller's counts of its
// arguments (N_QPTR and N_JINT here). Returns cudaGetLastError() (0 =
// launched), -2 where the counts differ, or -1 for bad sizes.
extern "C" int jtpu_walk_paths(const void* const* ptrs, int n_ptr, const int* ints, int n_int,
                               void* stream) {
  if (n_ptr != N_QPTR || n_int != N_JINT) return -2;
  WalkParams p;
  for (int i = 0; i < N_QPTR; ++i) p.ptr[i] = ptrs[i];
  for (int i = 0; i < N_JINT; ++i) p.i[i] = ints[i];
  if (p.i[J_B] <= 0 || p.i[J_T] <= 0 || p.i[J_K] <= 0 || p.i[J_COPY_ROWS] < 0 ||
      p.i[J_COPY_ROWS] > p.i[J_T] + 1) {
    return -1;
  }
  const int blocks = (p.i[J_B] + kWalkWarps - 1) / kWalkWarps;
  path_walk_kernel<<<blocks, 32 * kWalkWarps, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Words of one utterance's walk header (kHeadWords).
extern "C" int jtpu_walk_head_words() { return kHeadWords; }

// The header's field names in word order, each followed by a comma.
extern "C" const char* jtpu_walk_head_names() {
#define JTPU_HEAD_NAME(e, s) #s ","
  return JTPU_WALK_HEAD(JTPU_HEAD_NAME);
#undef JTPU_HEAD_NAME
}
