// The vector patterns of the Mosaic probe, as hand-written Hopper kernels.
//
// Replaces the nine Pallas TPU kernel bodies `kA`..`kI` that
// `scripts/pallas_probe.py` (`make`, its `pl.pallas_call`) compiles to learn
// which Mosaic relayouts the TPU takes. Each kernel here computes what its
// probes compute, not how Mosaic computes it:
//
//   probe_product  (probes A, B, C) out (R, N) = x (R, Kd) @ t (Kd, N) in
//                  full float32: fmaf on the CUDA cores, no TF32 (as the GMM
//                  kernel, for the same reason: a product in fewer bits moves
//                  Viterbi ties). A, B and C differ only in the output's
//                  layout (2-D, reshaped to 3-D, a batched dot_general); the
//                  caller views the output.
//   probe_gather   (probes E, I) out[r, :] = tab[int(idx[r]), :] where
//                  idx[r] is an integer-valued float in [0, n_rows), else a
//                  row of zeros: what the one-hot (== iota) matmul computes.
//                  The one-hot product is the TPU's way to gather; here the
//                  row is read by index. I's 512-row chunks are a Mosaic
//                  workaround and are not carried over.
//   probe_extract  (probes D, F, G, H) a strided copy: rows row0..row0+n_rows
//                  and columns col0..col0+n_cols of a row-major matrix of
//                  `row_stride` columns: a column (D, F, G), a contiguous
//                  range of rows (H), or any other block.
//   probe_empty    a kernel that does nothing: the yardstick of the card's
//                  fixed cost for a launch, timed beside every probe.
//   probe_touch    one thread reads one float and writes it: that cost and
//                  one trip to memory with its write-back, the shortest
//                  chain a kernel that reads its input can have. Timed
//                  beside every probe too; like probe_empty it replaces
//                  nothing and lies on no path.
//
// What bounds them on an H100: bytes, and at the probe's sizes (1.2 MB at
// most; the copies move 8-16 KB) the latency of a trip to memory on top of
// the fixed cost of a launch (`probe_empty`'s time). The product does
// 2*R*Kd*N operations on 4*(R*Kd + Kd*N + R*N) bytes (16 operations a
// float of x at N=16): 0.35 us of bytes at the probe's (2048, 128) x
// (128, 16), 0.13 us of float32 FMA issue. Kernels this small wait on
// latency, so the designs cut dependent steps and the L2 traffic that
// grows with the grid:
//
// probe_product:
//   - a block is 4 warps and takes 32 rows a pass (64 blocks at R=2048:
//     more blocks stage t more often and read slower); 8 lanes of a warp
//     share 2 rows, lane j taking k = j, j+8, j+16, ...: each x load is one
//     32-byte sector a row, needs no alignment and no staging, and the
//     first pass's are issued before t is staged;
//   - t is staged once a block, zero-padded to round_up(Kd, 8) rows and
//     round_up(N, 16) + 4 columns, by 16-byte loads where N % 4 == 0 and t
//     is 16-byte aligned, by floats otherwise; a thread issues 8 loads
//     before it stores any (cp.async staging measured slower). The row
//     stride is an odd number of 16-byte units, so the 8 lanes of a row
//     read 8 distinct bank groups, and the 4 row groups of a warp share
//     each read (a broadcast);
//   - a lane keeps 16 independent partial sums a row (one an output
//     column), 8 FMAs a 16-byte shared read; passes over k that end inside
//     Kd run without a guard, so their shared reads can be issued ahead.
//     The 8 lanes of a row then halve their sums three times by shuffles (a
//     reduce-scatter: 8 + 4 + 2 shuffles, not 16 full reductions), leaving
//     lane j columns 2j and 2j+1;
//   - N > 16 is taken 16 columns a pass, Kd > 128 128 a pass. The sum runs
//     in another order than ascending k; the arithmetic stays float32 fmaf.
//   Shared memory: 4 * round_up(Kd, 8) * (round_up(N, 16) + 4) bytes
//   (10,240 at the probe); above 48 KB the block opts in, up to the 227 KB
//   an H100 block may take.
//
// probe_gather: 4 lanes take a row; they read idx[r] at one address (one
// request for a warp's 8 rows; handing it over by a shuffle measured
// slower) and test it; the row is copied as 16-byte float4 where
// W % 4 == 0 and both pointers are 16-byte aligned, as floats otherwise.
// No 64-bit division. What bounds it is what is left, the dependent chain
// index -> row -> store: two trips to memory on top of writing the output.
// Staging a small table in shared memory while the index is in flight, to
// cut one trip, measured no faster and was not kept.
//
// probe_extract: one read and one write an element, so what bounds it is
// one trip to memory and the write-back, as `probe_touch`; the design cuts
// the instructions in front of the load. The entry point picks the kernel:
//   - a contiguous span (col0 == 0 and n_cols == row_stride, or one row;
//     H): out[i] = src[i] by float4 where src and out are 16-byte aligned,
//     the n % 4 floats after the last float4 copied by the first block's
//     first threads; by floats otherwise. 256 threads a block, a float4 a
//     thread (H: 4 blocks);
//   - a column (n_cols == 1; D, F, G): the same kernel by floats at a
//     stride of row_stride, a row a thread, 128 threads a block (16
//     blocks). Each float lies in a 32-byte sector of its own (16 floats a
//     row), which the layout forces;
//   - any other block: a warp a row, its lanes along the columns.
// No division on any path; offsets are 64-bit. Every kernel loops
// grid-stride over a grid capped at kMaxBlocks, so any size is copied.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit, at the
// probes' shapes: 256 threads a block took 0.02 us off H and added
// 0.04-0.05 us to the column, against 128. Not kept: int offsets where the
// extent fits in 31 bits (no faster than 64-bit ones), unsigned 32-bit
// offsets (0.02-0.03 us slower on the column), 512 or 1,024 threads a
// block or 2 or 4 elements a thread (loaded before any is stored), slower
// on both; 32 or 64 threads a block, no faster.
//
// Plain C interface (built by `_cuda_build` with nvcc for sm_90a, loaded
// with ctypes by `ops/probe_cuda.py`): each entry point launches on the
// given stream and returns cudaGetLastError() of the launch; none
// synchronises or allocates.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxBlocks = 4096;  // grid of the grid-stride kernels
constexpr unsigned kFull = 0xffffffffu;

// product
constexpr int kProductWarps = 4;
constexpr int kProductThreads = 32 * kProductWarps;
constexpr int kRowLanes = 8;   // lanes that share a row of x
constexpr int kGroupRows = 2;  // rows a group of kRowLanes lanes takes a pass
constexpr int kProductRows = kProductWarps * 32 / kRowLanes * kGroupRows;  // a block a pass
constexpr int kTileN = 16;     // output columns a pass
constexpr int kStepsK = 16;    // k values a lane takes a pass
constexpr int kTileK = kRowLanes * kStepsK;  // k a pass: 128

// gather
constexpr int kGatherThreads = 128;
constexpr int kGatherLanes = 4;  // lanes a row

// extract: threads a block of a contiguous span, and of a column or any
// other block
constexpr int kSpanThreads = 256;
constexpr int kExtractThreads = 128;

__host__ __device__ inline int product_stride(int N) {
  // floats a staged row of t: whole 16-column tiles and 4 more, an odd
  // number of 16-byte units
  return (N + kTileN - 1) / kTileN * kTileN + 4;
}

__host__ __device__ inline int product_k_rows(int Kd) {
  return (Kd + kRowLanes - 1) / kRowLanes * kRowLanes;
}

size_t product_smem(int Kd, int N) {
  return sizeof(float) * (size_t)product_k_rows(Kd) * (size_t)product_stride(N);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Stage t into shared memory, zero-padded to kp rows of sp floats, by
// elements of type T: float4 where N % 4 == 0 and t is 16-byte aligned,
// float otherwise. A thread issues 8 loads before it stores any.
template <typename T>
__device__ __forceinline__ void stage_t(T* __restrict__ ts, const float* __restrict__ t, int Kd,
                                        int N, int kp, int sp) {
  constexpr int kWidth = sizeof(T) / sizeof(float);
  constexpr int kChunk = 8;
  const int n = N / kWidth, s = sp / kWidth, total = kp * s;
  for (int q0 = threadIdx.x; q0 < total; q0 += kProductThreads * kChunk) {
    T v[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int q = q0 + c * kProductThreads, k = q / s, u = q - k * s;
      v[c] = q < total && k < Kd && u < n
                 ? __ldg(reinterpret_cast<const T*>(t + (size_t)k * N) + u)
                 : T{};
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      if (q0 + c * kProductThreads < total) ts[q0 + c * kProductThreads] = v[c];
  }
}

// One step of the reduce-scatter: the lanes `off` apart swap halves of
// their kN sums; each keeps the half its bit `upper` names, summed.
template <int kN>
__device__ __forceinline__ void halve(float* v, int off, bool upper) {
#pragma unroll
  for (int q = 0; q < kN / 2; ++q) {
    const float send = upper ? v[q] : v[q + kN / 2];
    const float keep = upper ? v[q + kN / 2] : v[q];
    v[q] = keep + __shfl_xor_sync(kFull, send, off);
  }
}

// The FMAs of one pass over k (k0..k0+127) for kGroupRows rows: t's rows
// k0 + j + 8i from shared memory, 16 columns from c0. kGuard: the pass runs
// past Kd, and the steps beyond it are skipped (the same in the whole block).
template <bool kGuard>
__device__ __forceinline__ void product_pass(const float* ts, int sp, int k0, int Kd, int j,
                                             int c0, const float (&xk)[kGroupRows][kStepsK],
                                             float (&acc)[kGroupRows][kTileN]) {
#pragma unroll
  for (int i = 0; i < kStepsK; ++i) {
    if (kGuard && k0 + kRowLanes * i >= Kd) break;
    const float4* tr =
        reinterpret_cast<const float4*>(ts + (size_t)(k0 + j + kRowLanes * i) * sp + c0);
#pragma unroll
    for (int u = 0; u < kTileN / 4; ++u) {
      const float4 tv = tr[u];
#pragma unroll
      for (int m = 0; m < kGroupRows; ++m) {
        acc[m][4 * u + 0] = fmaf(xk[m][i], tv.x, acc[m][4 * u + 0]);
        acc[m][4 * u + 1] = fmaf(xk[m][i], tv.y, acc[m][4 * u + 1]);
        acc[m][4 * u + 2] = fmaf(xk[m][i], tv.z, acc[m][4 * u + 2]);
        acc[m][4 * u + 3] = fmaf(xk[m][i], tv.w, acc[m][4 * u + 3]);
      }
    }
  }
}

template <bool kVecT>
__global__ void __launch_bounds__(kProductThreads)
probe_product_kernel(const float* __restrict__ x, const float* __restrict__ t,
                     float* __restrict__ out, int R, int Kd, int N) {
  static_assert(kRowLanes == 8 && kTileN == 16, "the reduce-scatter below halves 16 by 8 lanes");
  extern __shared__ float4 ts4[];
  const float* ts = reinterpret_cast<const float*>(ts4);
  const int sp = product_stride(N);
  const int kp = product_k_rows(Kd);
  bool staged = false;  // the same in every thread of the block
  const int lane = threadIdx.x & 31;
  const int j = lane & (kRowLanes - 1);
  // this lane group's first row in a block's pass
  const int row = ((threadIdx.x >> 5) * (32 / kRowLanes) + lane / kRowLanes) * kGroupRows;
  for (int r0 = blockIdx.x * kProductRows; r0 < R; r0 += gridDim.x * kProductRows) {
    for (int c0 = 0; c0 < N; c0 += kTileN) {
      float acc[kGroupRows][kTileN] = {};
      for (int k0 = 0; k0 < Kd; k0 += kTileK) {
        float xk[kGroupRows][kStepsK];
#pragma unroll
        for (int m = 0; m < kGroupRows; ++m) {
          const int r = r0 + row + m;
#pragma unroll
          for (int i = 0; i < kStepsK; ++i) {
            const int k = k0 + j + kRowLanes * i;
            xk[m][i] = (r < R && k < Kd) ? x[(size_t)r * Kd + k] : 0.0f;
          }
        }
        if (!staged) {  // the first pass's x loads are in flight while t is staged
          if (kVecT) stage_t(ts4, t, Kd, N, kp, sp);
          else stage_t(reinterpret_cast<float*>(ts4), t, Kd, N, kp, sp);
          __syncthreads();
          staged = true;
        }
        if (k0 + kTileK <= Kd) product_pass<false>(ts, sp, k0, Kd, j, c0, xk, acc);
        else product_pass<true>(ts, sp, k0, Kd, j, c0, xk, acc);
      }
#pragma unroll
      for (int m = 0; m < kGroupRows; ++m) {
        halve<16>(acc[m], 4, j & 4);
        halve<8>(acc[m], 2, j & 2);
        halve<4>(acc[m], 1, j & 1);
        // lane j now holds columns c0 + 2j and c0 + 2j + 1 of row r
        const int r = r0 + row + m, c = c0 + 2 * j;
        if (r < R && c < N) {
          out[(size_t)r * N + c] = acc[m][0];
          if (c + 1 < N) out[(size_t)r * N + c + 1] = acc[m][1];
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
probe_gather_kernel(const float* __restrict__ idx, const T* __restrict__ tab,
                    T* __restrict__ out, int R, int n_rows, int w) {
  constexpr int kRowsPerWarp = 32 / kGatherLanes;
  const int lane = threadIdx.x & 31;
  const int j = lane & (kGatherLanes - 1);
  const int warp = (blockIdx.x * kGatherThreads + threadIdx.x) >> 5;
  const int warps = gridDim.x * (kGatherThreads / 32);
  for (int r0 = warp * kRowsPerWarp; r0 < R; r0 += warps * kRowsPerWarp) {
    const int r = r0 + lane / kGatherLanes;
    // the 4 lanes of a row read one address: one request for the warp's
    // 8 indices
    int src = -1;
    if (r < R) {
      const float v = idx[r];
      // a NaN fails every comparison, as it matches no one-hot column
      if (v >= 0.0f && v < (float)n_rows && v == floorf(v)) src = (int)v;
    }
    if (r < R) {
      T* o = out + (size_t)r * w;
      if (src >= 0) {
        const T* s = tab + (size_t)src * w;
        for (int c = j; c < w; c += kGatherLanes) o[c] = s[c];
      } else {
        for (int c = j; c < w; c += kGatherLanes) o[c] = T{};
      }
    }
  }
}

// out[i] = src[i * stride] for i < n, in units of T (a span: float4 or float
// at stride 1; a column: float at the matrix's row stride); then the `tail`
// floats that follow a span of n float4s, one a thread of the first block.
template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads)
probe_extract_kernel(const T* __restrict__ src, T* __restrict__ out, long long n,
                     long long stride, int tail) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    out[i] = __ldg(src + i * stride);
  if (blockIdx.x == 0 && (int)threadIdx.x < tail)
    reinterpret_cast<float*>(out + n)[threadIdx.x] =
        __ldg(reinterpret_cast<const float*>(src + n) + threadIdx.x);
}

// Any other block of rows and columns: a warp a row, its lanes along the
// columns.
__global__ void __launch_bounds__(kExtractThreads)
probe_extract_kernel_block(const float* __restrict__ src, float* __restrict__ out, int n_rows,
                           int row_stride, int n_cols) {
  constexpr int kWarps = kExtractThreads / 32;
  const int lane = threadIdx.x & 31;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); r < n_rows;
       r += (long long)gridDim.x * kWarps) {
    const float* s = src + r * row_stride;
    float* o = out + r * n_cols;
    for (int c = lane; c < n_cols; c += 32) o[c] = __ldg(s + c);
  }
}

__global__ void probe_empty_kernel() {}

__global__ void probe_touch_kernel(const float* __restrict__ src, float* __restrict__ dst) {
  if (threadIdx.x == 0) dst[0] = src[0];
}

int blocks_of(long long items, int per_block) {
  const long long blocks = (items + per_block - 1) / per_block;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <bool kVecT>
int launch_product(const float* x, const float* t, float* out, int R, int Kd, int N,
                   cudaStream_t stream) {
  // the opt-in to more than 48 KB is set once per instantiation, device and
  // size
  constexpr int kMaxDevices = 64;
  static size_t allowed_on[kMaxDevices];
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  const size_t smem = product_smem(Kd, N);
  size_t& allowed = allowed_on[device];
  if (smem > 48 * 1024 && smem > allowed) {
    const cudaError_t rc = cudaFuncSetAttribute(
        probe_product_kernel<kVecT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    allowed = smem;
  }
  probe_product_kernel<kVecT><<<blocks_of(R, kProductRows), kProductThreads, smem, stream>>>(
      x, t, out, R, Kd, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// shared memory of a product block (the wrapper refuses what an H100 block
// cannot take)
long long jtpu_probe_product_smem_bytes(int Kd, int N) { return (long long)product_smem(Kd, N); }

int jtpu_probe_product(const float* x, const float* t, float* out, int R, int Kd, int N,
                       void* stream) {
  if (R <= 0 || Kd <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return N % 4 == 0 && aligned16(t) ? launch_product<true>(x, t, out, R, Kd, N, s)
                                    : launch_product<false>(x, t, out, R, Kd, N, s);
}

int jtpu_probe_gather(const float* idx, const float* tab, float* out, int R, int n_rows, int W,
                      void* stream) {
  if (R <= 0 || n_rows <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = blocks_of(R, kGatherThreads / kGatherLanes);
  const cudaStream_t s = (cudaStream_t)stream;
  if (W % 4 == 0 && aligned16(tab) && aligned16(out))
    probe_gather_kernel<float4><<<blocks, kGatherThreads, 0, s>>>(
        idx, reinterpret_cast<const float4*>(tab), reinterpret_cast<float4*>(out), R, n_rows,
        W / 4);
  else
    probe_gather_kernel<float><<<blocks, kGatherThreads, 0, s>>>(idx, tab, out, R, n_rows, W);
  return (int)cudaGetLastError();
}

int jtpu_probe_extract(const float* x, float* out, int n_rows, int row0, int row_stride,
                       int col0, int n_cols, void* stream) {
  if (n_rows <= 0 || n_cols <= 0 || row0 < 0 || col0 < 0 || col0 + n_cols > row_stride)
    return (int)cudaErrorInvalidValue;
  const float* src = x + (size_t)row0 * row_stride + col0;
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int kS = kSpanThreads, kT = kExtractThreads;
  if (n_rows == 1 || n_cols == row_stride) {  // one contiguous span
    const long long n = (long long)n_rows * n_cols;
    if (aligned16(src) && aligned16(out))
      probe_extract_kernel<float4, kS><<<blocks_of((n + 3) / 4, kS), kS, 0, s>>>(
          reinterpret_cast<const float4*>(src), reinterpret_cast<float4*>(out), n / 4, 1,
          (int)(n % 4));
    else
      probe_extract_kernel<float, kS><<<blocks_of(n, kS), kS, 0, s>>>(src, out, n, 1, 0);
  } else if (n_cols == 1) {
    probe_extract_kernel<float, kT><<<blocks_of(n_rows, kT), kT, 0, s>>>(src, out, n_rows,
                                                                         row_stride, 0);
  } else {
    probe_extract_kernel_block<<<blocks_of(n_rows, kT / 32), kT, 0, s>>>(src, out, n_rows,
                                                                          row_stride, n_cols);
  }
  return (int)cudaGetLastError();
}

int jtpu_probe_empty(void* stream) {
  probe_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

int jtpu_probe_touch(const float* src, float* dst, void* stream) {
  probe_touch_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(src, dst);
  return (int)cudaGetLastError();
}

}  // extern "C"
