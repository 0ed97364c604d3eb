// Fused all-GMM log-likelihood scoring for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of juicer_tpu/ops/gmm_pallas.py:29
// (built by `_build`, wrapped by `make_pallas_gmm_scorer`). It computes, for
// every frame t and every GMM g,
//
//   out[t, g] = logsumexp_c( sum_d x[t,d]^2 V[d,g,c] + x[t,d] M[d,g,c] + b[g,c] )
//
// over the GMM's components, with the quadratic form expanded offline
// (juicer_tpu_torch/am/models.py: flat_params). The parameters keep the
// plain scorer's g-major column order (juicer_tpu_torch/ops/gmm_cuda.py:
// pack_params): W (2D, G_pad * C_pad) is [V; M] with column g * C_pad + c,
// b (G_pad, C_pad). G pads to the GMM tile (16), C to a multiple of the
// component chunk (8); a padded component has zero weights and b = -1e30 and
// vanishes in the exponential; a GMM whose components are all padded outputs
// -1e30. Any T >= 1, any G, D up to kMaxDim and C up to kMaxComps.
//
// What bounds it on an H100: operations. 2 * T * G * C * 2D flops of
// multiply-adds against (T*D + 2D*G*C + G*C + T*G) * 4 bytes: at the main
// path's shapes (G = 141, C = 8, D = 39) 4.1 GFLOP against 4.3 MB at
// T = 23,328 (16 x 1458 frames) and 33.9 GFLOP against 35.7 MB at
// T = 192,456 (132 x 1458), 0.061 and 0.506 ms at the 67 TFLOP/s float32
// rate of the CUDA cores, against 0.001 and 0.011 ms for the bytes.
//
// Tiling: a block of 128 threads scores a tile of 64 frames x 16 GMMs x 8
// components (a 64 x 128 tile of the product). Thread (ty, tx) holds frames
// 8 ty .. 8 ty + 7 and all 8 components of GMM tx: 64 float32 accumulators
// in registers. Per input dimension d it loads its 8 x values (two 16-byte
// shared loads) and its 8 V and 8 M weights (four), squares the 8 x values
// and issues 128 FMAs: 6 loads and 8 multiplies per 128 FMAs, where the
// first kernel issued 5 loads per 4 FMAs. A warp spans 4 frame groups x 8
// GMMs, so each shared load is one 128-byte wavefront (x broadcast, W
// consecutive). 127 registers, no spills; four blocks an SM
// (__launch_bounds__(128, 4)), whose staging, barriers and logsumexp fall
// at different times, so one block's FMAs cover another's waits.
//
// Staging: the block copies its x tile (64 frames x D, transposed to
// d-major, row stride 68 floats) and the W rows of up to kDimChunk dims (V
// and M rows, 128 columns in two 4-component halves) into shared memory by
// cp.async; frames beyond T are zero-filled. 50,544 bytes at D = 39. Larger
// D loops over W chunks of kDimChunk dims (accumulators kept), as a GEMM
// loops over K; C_pad > 8 loops over components 8 at a time. At C <= 8 (the
// main path) both loops run once and the logsumexp is a max over the
// thread's 8 registers, then 8 exponentials, in the plain version's order.
// Blocks walk the GMM tiles of a frame tile next to each other, so a frame
// tile's x is read from device memory once and from L2 for the other GMM
// tiles; W (0.36 MB at the main path) stays in L2.
//
// What holds it below the peak (PERF.md, section 6): the FMA loop itself,
// which issues FMAs at well under one a cycle a scheduler though they are
// 90 % of its instructions, and the tile's fixed work (staging, bias,
// exponentials, stores). A persistent grid that copies the next tile by
// cp.async while computing, with W resident, was built and measured slower.
//
// No tensor cores: the expanded form cancels terms of ~1e4 into scores of
// ~1e2 when x is close to a mean; a TF32 or bf16 product perturbs scores
// by ~1e-3, enough to flip Viterbi ties downstream. Every product is a full
// float32 FMA. No atomics and no cross-block reduction: a frame's scores do
// not depend on where it sits in the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kFrames = 64;    // frame tile
constexpr int kGmms = 16;      // GMM tile
constexpr int kComps = 8;      // component chunk: the columns of a thread
constexpr int kCols = kGmms * kComps;
constexpr int kFpt = 8;        // frames a thread
constexpr int kXStride = kFrames + 4;  // x row stride: 16-byte rows, staged writes spread over banks
constexpr int kDimChunk = 40;  // input dims of W staged at a time
constexpr int kMaxDim = 192;
constexpr int kMaxComps = 32;
constexpr float kNeg = -1.0e30f;

static_assert(kThreads == (kFrames / kFpt) * kGmms, "one thread per (frame group, GMM)");

size_t smem_bytes(int D) {
  const int wrows = D < kDimChunk ? D : kDimChunk;
  return sizeof(float) * ((size_t)D * kXStride + (size_t)2 * wrows * kCols);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 4)
gmm_logsumexp_kernel(const float* __restrict__ x,   // (T, D)
                     const float* __restrict__ W,   // (2D, G_pad * C_pad)
                     const float* __restrict__ b,   // (G_pad, C_pad)
                     float* __restrict__ out,       // (T, G)
                     int T, int D, int G, int G_pad, int C_pad) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                        // (D, kXStride): x[t0 + f, d] at d * kXStride + f
  float* ws = smem + D * kXStride;         // (2 * wrows, kCols): V rows, then M rows
  const int wrows = D < kDimChunk ? D : kDimChunk;

  const int n_gt = G_pad / kGmms;
  const int gt = blockIdx.x % n_gt;
  const int t0 = (blockIdx.x / n_gt) * kFrames;
  const int g0 = gt * kGmms;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tx = ((warp & 1) << 3) | (lane & 7);   // GMM of the tile
  const int ty = ((warp >> 1) << 2) | (lane >> 3); // frame group of the tile
  const size_t ncols = (size_t)G_pad * C_pad;

  // the x tile, transposed to d-major; frames past T read as zeros
  {
    int f = tid / D, d = tid - (tid / D) * D;
    const int fstep = kThreads / D, dstep = kThreads - (kThreads / D) * D;
    for (int i = tid; i < kFrames * D; i += kThreads) {
      const int t = t0 + f;
      const bool live = t < T;
      cp_async4(xs + d * kXStride + f, live ? x + (size_t)t * D + d : x, live ? 4 : 0);
      f += fstep;
      d += dstep;
      if (d >= D) {
        d -= D;
        ++f;
      }
    }
  }

  float m[kFpt], s[kFpt];
#pragma unroll
  for (int i = 0; i < kFpt; ++i) {
    m[i] = -INFINITY;
    s[i] = 0.0f;
  }

  for (int c0 = 0; c0 < C_pad; c0 += kComps) {
    float acc[kFpt][kComps];
#pragma unroll
    for (int i = 0; i < kFpt; ++i)
#pragma unroll
      for (int j = 0; j < kComps; ++j) acc[i][j] = 0.0f;

    for (int d0 = 0; d0 < D; d0 += kDimChunk) {
      const int dc = D - d0 < kDimChunk ? D - d0 : kDimChunk;
      if (c0 > 0 || d0 > 0) __syncthreads();  // every thread is done with the last W chunk
      // W rows d0 .. d0 + dc of V and of M, the tile's 128 columns of this
      // component chunk, as 16-byte pieces: piece (h, gl) holds components
      // c0 + 4h .. c0 + 4h + 3 of GMM g0 + gl, stored at float4 index h * 16 + gl
      for (int i = tid; i < dc * 64; i += kThreads) {
        const int r = i >> 6, part = (i >> 5) & 1, h = (i >> 4) & 1, gl = i & 15;
        const float* src = W + (size_t)(part * D + d0 + r) * ncols
                           + (size_t)(g0 + gl) * C_pad + c0 + 4 * h;
        cp_async16(ws + (part * wrows + r) * kCols + h * 64 + gl * 4, src);
      }
      cp_async_wait_all();
      __syncthreads();

      const float* xrow = xs + d0 * kXStride + ty * kFpt;
      const float4* vrow = reinterpret_cast<const float4*>(ws) + tx;
      const float4* mrow = reinterpret_cast<const float4*>(ws + wrows * kCols) + tx;
#pragma unroll 2
      for (int dd = 0; dd < dc; ++dd) {
        const float4 xa = *reinterpret_cast<const float4*>(xrow + dd * kXStride);
        const float4 xb = *reinterpret_cast<const float4*>(xrow + dd * kXStride + 4);
        const float4 va = vrow[dd * 32], vb = vrow[dd * 32 + 16];
        const float4 ma = mrow[dd * 32], mb = mrow[dd * 32 + 16];
        const float xv[kFpt] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const float v[kComps] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
        const float w[kComps] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w};
#pragma unroll
        for (int i = 0; i < kFpt; ++i) {
          const float sq = xv[i] * xv[i];
#pragma unroll
          for (int j = 0; j < kComps; ++j) {
            acc[i][j] = fmaf(sq, v[j], acc[i][j]);
            acc[i][j] = fmaf(xv[i], w[j], acc[i][j]);
          }
        }
      }
    }

    // bias, then this chunk's logsumexp: at C_pad = 8 the max over the 8
    // registers and the sum of 8 exponentials; from the second chunk on,
    // merged into the running (max, sum)
    const float4* bp = reinterpret_cast<const float4*>(b + (size_t)(g0 + tx) * C_pad + c0);
    const float4 ba = __ldg(bp), bb = __ldg(bp + 1);
    const float bias[kComps] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int i = 0; i < kFpt; ++i) {
      float l[kComps];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kComps; ++j) {
        l[j] = acc[i][j] + bias[j];
        mx = fmaxf(mx, l[j]);
      }
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kComps; ++j) sum += __expf(l[j] - mx);
      if (c0 == 0) {
        m[i] = mx;
        s[i] = sum;
      } else {
        const float mn = fmaxf(m[i], mx);
        s[i] = s[i] * __expf(m[i] - mn) + sum * __expf(mx - mn);
        m[i] = mn;
      }
    }
  }

  const int g = g0 + tx;
  if (g >= G) return;
#pragma unroll
  for (int i = 0; i < kFpt; ++i) {
    const int t = t0 + ty * kFpt + i;
    if (t < T) out[(size_t)t * G + g] = (m[i] <= 0.5f * kNeg) ? kNeg : m[i] + __logf(s[i]);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take (the wrapper
// refuses those first).
extern "C" int jtpu_gmm_logsumexp(const float* x, const float* W, const float* b,
                                  float* out, int T, int D, int G, int G_pad,
                                  int C_pad, void* stream) {
  if (T <= 0 || G <= 0) return 0;
  if (D < 1 || D > kMaxDim || C_pad < kComps || C_pad > kMaxComps || C_pad % kComps
      || G_pad < G || G_pad % kGmms)
    return static_cast<int>(cudaErrorInvalidValue);
  // the opt-in above 48 KB of shared memory, once per device, for the largest D
  static bool opted[64] = {};
  int dev = 0;
  const cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return static_cast<int>(de);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_logsumexp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxDim)));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[dev] = true;
  }
  const long long blocks = (long long)((T + kFrames - 1) / kFrames) * (G_pad / kGmms);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gmm_logsumexp_kernel<<<static_cast<unsigned>(blocks), kThreads, smem_bytes(D),
                         static_cast<cudaStream_t>(stream)>>>(x, W, b, out, T, D, G, G_pad,
                                                              C_pad);
  return static_cast<int>(cudaGetLastError());
}
