// The vector patterns of the Mosaic probe, as hand-written Hopper kernels.
//
// Replaces the nine Pallas TPU kernel bodies `kA`..`kI` that
// `scripts/pallas_probe.py` (`make`, its `pl.pallas_call`) compiles to learn
// which Mosaic relayouts the TPU takes. Each kernel here computes what its
// probes compute, not how Mosaic computes it:
//
//   probe_product  (probes A, B, C) out (R, N) = x (R, Kd) @ t (Kd, N) in
//                  full float32: fmaf over k in ascending order on the CUDA
//                  cores, no TF32 (as the GMM kernel, for the same reason:
//                  a product in fewer bits moves Viterbi ties). A, B and C
//                  differ only in the output's layout (2-D, reshaped to 3-D,
//                  a batched dot_general); the caller views the output.
//   probe_gather   (probes E, I) out[r, :] = tab[int(idx[r]), :] where
//                  idx[r] is an integer-valued float in [0, n_rows), else a
//                  row of zeros: what the one-hot (== iota) matmul computes.
//                  The one-hot product is the TPU's way to gather; here a
//                  thread reads the row by index. I's 512-row chunks are a
//                  Mosaic workaround and are not carried over.
//   probe_extract  (probes D, F, G, H) a strided copy: rows row0..row0+n_rows
//                  and columns col0..col0+n_cols of a row-major matrix of
//                  `row_stride` columns (a column, or a range of rows).
//
// What bounds them on an H100: bytes. The product does 2*R*Kd*N operations
// on 4*(R*Kd + Kd*N + R*N) bytes (16 operations a float of x at N=16), far
// below the ~20 operations a byte where the float32 CUDA cores would bound
// it; the gather and the copy do none. At the probe's sizes (1 MB at most)
// every kernel is a few microseconds of launch and latency: each block
// stages what it reads once (the product: the whole of t and its 16 rows of
// x in shared memory) and every thread writes neighbouring addresses.
//
// Plain C interface (built by `_cuda_build` with nvcc for sm_90a, loaded
// with ctypes by `ops/probe_cuda.py`): each entry point launches on the
// given stream and returns cudaGetLastError() of the launch; none
// synchronises or allocates.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kProductRows = 16;  // rows of x a product block takes
constexpr int kMaxBlocks = 4096;  // grid of the grid-stride kernels

__global__ void __launch_bounds__(kThreads)
probe_product_kernel(const float* __restrict__ x, const float* __restrict__ t,
                     float* __restrict__ out, int R, int Kd, int N) {
  extern __shared__ float smem[];
  float* ts = smem;           // Kd * N: all of t
  float* xs = smem + Kd * N;  // kProductRows * Kd: this block's rows of x
  const int r0 = blockIdx.x * kProductRows;
  const int rows = min(kProductRows, R - r0);
  for (int i = threadIdx.x; i < Kd * N; i += blockDim.x) ts[i] = t[i];
  const float* xb = x + (size_t)r0 * Kd;
  for (int i = threadIdx.x; i < rows * Kd; i += blockDim.x) xs[i] = xb[i];
  __syncthreads();
  for (int o = threadIdx.x; o < rows * N; o += blockDim.x) {
    const int r = o / N;
    const int c = o - r * N;
    const float* xr = xs + r * Kd;
    float acc = 0.0f;
    for (int k = 0; k < Kd; ++k) acc = fmaf(xr[k], ts[k * N + c], acc);
    out[(size_t)(r0 + r) * N + c] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
probe_gather_kernel(const float* __restrict__ idx, const float* __restrict__ tab,
                    float* __restrict__ out, int R, int n_rows, int W) {
  const long long n = (long long)R * W;
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x; o < n;
       o += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(o / W);
    const int c = (int)(o - (long long)r * W);
    const float v = idx[r];
    float val = 0.0f;
    // a NaN fails every comparison, as it matches no one-hot column
    if (v >= 0.0f && v < (float)n_rows && v == floorf(v)) val = tab[(size_t)(int)v * W + c];
    out[o] = val;
  }
}

__global__ void __launch_bounds__(kThreads)
probe_extract_kernel(const float* __restrict__ x, float* __restrict__ out, int n_rows,
                     int row0, int row_stride, int col0, int n_cols) {
  const long long n = (long long)n_rows * n_cols;
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x; o < n;
       o += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(o / n_cols);
    const int c = (int)(o - (long long)r * n_cols);
    out[o] = x[(size_t)(row0 + r) * row_stride + col0 + c];
  }
}

int grid_of(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" {

// shared memory of a product block; the wrapper keeps it within the 48 KB a
// block takes without an opt-in
long long jtpu_probe_product_smem_bytes(int Kd, int N) {
  return (long long)sizeof(float) * ((long long)Kd * N + (long long)kProductRows * Kd);
}

int jtpu_probe_product(const float* x, const float* t, float* out, int R, int Kd, int N,
                       void* stream) {
  if (R <= 0 || Kd <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)jtpu_probe_product_smem_bytes(Kd, N);
  const int blocks = (R + kProductRows - 1) / kProductRows;
  probe_product_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(x, t, out, R, Kd, N);
  return (int)cudaGetLastError();
}

int jtpu_probe_gather(const float* idx, const float* tab, float* out, int R, int n_rows, int W,
                      void* stream) {
  if (R <= 0 || n_rows <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  probe_gather_kernel<<<grid_of((long long)R * W), kThreads, 0, (cudaStream_t)stream>>>(
      idx, tab, out, R, n_rows, W);
  return (int)cudaGetLastError();
}

int jtpu_probe_extract(const float* x, float* out, int n_rows, int row0, int row_stride,
                       int col0, int n_cols, void* stream) {
  if (n_rows <= 0 || n_cols <= 0 || row0 < 0 || col0 < 0 || col0 + n_cols > row_stride)
    return (int)cudaErrorInvalidValue;
  probe_extract_kernel<<<grid_of((long long)n_rows * n_cols), kThreads, 0,
                         (cudaStream_t)stream>>>(x, out, n_rows, row0, row_stride, col0, n_cols);
  return (int)cudaGetLastError();
}

}  // extern "C"
