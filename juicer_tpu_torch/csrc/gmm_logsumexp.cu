// Fused all-GMM log-likelihood scoring for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of juicer_tpu/ops/gmm_pallas.py
// (built by `_build`, wrapped by `make_pallas_gmm_scorer`). It computes, for
// every frame t and every GMM g,
//
//   out[t, g] = logsumexp_c( sum_d x[t,d]^2 V[c,d,g] + x[t,d] M[c,d,g] + b[c,g] )
//
// over the GMM's components, with the quadratic form expanded offline
// (juicer_tpu_torch/am/models.py: flat_params). Parameters arrive packed
// component-major by the wrapper (juicer_tpu_torch/ops/gmm_cuda.py:
// pack_params), as the Pallas wrapper packs them: W (C, 2D, G_pad) holds
// [V; M] for component c, b (C, G_pad). A padded component has b = -1e30 and
// vanishes in the exponential; a GMM whose components are all padded
// outputs -1e30.
//
// What bounds it on an H100: at the main path's shapes (16,000 frames, 141
// GMMs, 8 components, D = 39) one call is about 2.8 GFLOP of multiply-adds
// against about 14 MB of traffic, so it is bound by operations. They run in
// full float32 FMA on the CUDA cores: the expanded form cancels strongly
// when x is close to a mean, and TF32 or bf16 tensor-core products perturb
// scores by ~1e-3, enough to flip Viterbi ties downstream.
//
// Design (simple, correct first): one block per (32-frame x 32-GMM) tile,
// 32 x 8 threads. The tile's [x^2, x] rows are staged once in shared memory;
// each thread owns one GMM and FPT = 4 frames, loops over the components and
// the 2D inputs with register accumulators (the weight it loads is reused
// for 4 frames; the frame values are a warp-wide shared-memory broadcast),
// and keeps a running max-and-sum logsumexp per frame in registers. The
// warp's 32 GMMs are contiguous in W and in the output, so every global
// access is coalesced. No tensor cores, no atomics, no cross-block
// reduction: results do not depend on scheduling.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGmmTile = 32;   // threads along GMMs (one warp)
constexpr int kRows = 8;       // thread rows along frames
constexpr int kFpt = 4;        // frames per thread
constexpr int kFrameTile = kRows * kFpt;
constexpr float kNeg = -1.0e30f;

__global__ void __launch_bounds__(kGmmTile * kRows)
gmm_logsumexp_kernel(const float* __restrict__ x,   // (T, D)
                     const float* __restrict__ W,   // (C, 2D, G_pad)
                     const float* __restrict__ b,   // (C, G_pad)
                     float* __restrict__ out,       // (T, G)
                     int T, int D, int G, int G_pad, int C) {
  extern __shared__ float xs[];  // (kFrameTile, 2D): [x^2 | x] per frame
  const int D2 = 2 * D;
  const int t0 = blockIdx.x * kFrameTile;
  const int tid = threadIdx.y * kGmmTile + threadIdx.x;
  for (int i = tid; i < kFrameTile * D; i += kGmmTile * kRows) {
    const int tt = i / D;
    const int d = i - tt * D;
    const int t = t0 + tt;
    const float v = (t < T) ? x[(size_t)t * D + d] : 0.0f;
    xs[tt * D2 + d] = v * v;
    xs[tt * D2 + D + d] = v;
  }
  __syncthreads();

  const int g = blockIdx.y * kGmmTile + threadIdx.x;
  if (g >= G) return;
  const float* xrow = xs + threadIdx.y * kFpt * D2;

  float m[kFpt], s[kFpt];
#pragma unroll
  for (int i = 0; i < kFpt; ++i) {
    m[i] = -INFINITY;
    s[i] = 0.0f;
  }
  for (int c = 0; c < C; ++c) {
    const float* Wc = W + (size_t)c * D2 * G_pad + g;
    float acc[kFpt];
#pragma unroll
    for (int i = 0; i < kFpt; ++i) acc[i] = 0.0f;
    for (int d = 0; d < D2; ++d) {
      const float w = __ldg(Wc + (size_t)d * G_pad);
#pragma unroll
      for (int i = 0; i < kFpt; ++i) acc[i] = fmaf(xrow[i * D2 + d], w, acc[i]);
    }
    const float bc = __ldg(b + (size_t)c * G_pad + g);
#pragma unroll
    for (int i = 0; i < kFpt; ++i) {
      const float l = acc[i] + bc;
      if (l > m[i]) {
        s[i] = s[i] * expf(m[i] - l) + 1.0f;
        m[i] = l;
      } else {
        s[i] += expf(l - m[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kFpt; ++i) {
    const int t = t0 + threadIdx.y * kFpt + i;
    if (t < T) out[(size_t)t * G + g] = (m[i] <= 0.5f * kNeg) ? kNeg : m[i] + logf(s[i]);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int jtpu_gmm_logsumexp(const float* x, const float* W, const float* b,
                                  float* out, int T, int D, int G, int G_pad,
                                  int C, void* stream) {
  if (T <= 0 || G <= 0) return 0;
  const dim3 block(kGmmTile, kRows);
  const dim3 grid((T + kFrameTile - 1) / kFrameTile, (G + kGmmTile - 1) / kGmmTile);
  const size_t smem = (size_t)kFrameTile * 2 * D * sizeof(float);
  gmm_logsumexp_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      x, W, b, out, T, D, G, G_pad, C);
  return static_cast<int>(cudaGetLastError());
}

// Largest D the launch takes (the staged tile must fit 48 KB of shared memory).
extern "C" int jtpu_gmm_logsumexp_max_dim() {
  return static_cast<int>(48 * 1024 / (kFrameTile * 2 * sizeof(float)));
}
