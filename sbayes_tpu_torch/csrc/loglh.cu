// Collapsed Dirichlet-categorical log-likelihood, batched over chains.
//
// Replaces the TPU kernel sbayes_tpu/ops/pallas_kernels.py::_loglh_kernel
// (pl.pallas_call in make_pallas_log_likelihood.log_lh_batch). For each
// chain b it computes
//
//   sum over component rows r and features f of
//     lgamma(sum_s a) - lgamma(n + sum_s a) + sum_s [a > 0] (lgamma(c + a) - lgamma(a))
//
// where the rows are the K clusters and the Gmax groups of each
// confounder, c[r, f, s] counts the objects of row r whose feature f shows
// state s and is attributed (source) to the row's component, n = sum_s c.
//
// Design: one block per chain. The count tile rows x f_tile x S lives in
// shared memory as int32 and is built with shared-memory atomics, so the
// counts are exact integers; the block walks F in tiles when the whole
// table would pass the shared-memory budget. lgammaf replaces the TPU
// kernel's Stirling series (Mosaic has no lgamma). A block reduction ends
// with one float per chain.
//
// Bound on an H100: memory. Each chain reads the source of its observed
// cells (C bytes each) and its memberships (K*N bytes) once; the feature
// index and concentrations are shared and stay in L2. At B=1024, N=100,
// F=36, C=3 that is about 11 MB, about 3.3 us at 3.35 TB/s
// (ops/loglh.py: bytes_moved).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 48 * 1024;

__global__ void loglh_kernel(const uint8_t* __restrict__ clusters,   // (B, K, N)
                             const uint8_t* __restrict__ source,     // (B, N, F, C)
                             const int8_t* __restrict__ feat_idx,    // (N, F), S = NA
                             const int32_t* __restrict__ group_idx,  // (C-1, N), -1 = none
                             const float* __restrict__ conc_cl,      // (F, S)
                             const float* __restrict__ conc_conf,    // (C-1, G, F, S)
                             float* __restrict__ out,                // (B,)
                             int K, int N, int F, int S, int C, int G, int f_tile) {
  extern __shared__ int counts[];  // rows * f_tile * S
  __shared__ float warp_sums[kThreads / 32];
  const int b = blockIdx.x;
  const int rows = K + (C - 1) * G;
  const uint8_t* cl_b = clusters + (size_t)b * K * N;
  const uint8_t* src_b = source + (size_t)b * N * F * C;

  float acc = 0.f;
  for (int f0 = 0; f0 < F; f0 += f_tile) {
    const int ft = min(f_tile, F - f0);
    for (int i = threadIdx.x; i < rows * ft * S; i += blockDim.x) counts[i] = 0;
    __syncthreads();

    for (int i = threadIdx.x; i < N * ft; i += blockDim.x) {
      const int n = i / ft;
      const int fl = i - n * ft;
      const int f = f0 + fl;
      const int s = feat_idx[n * F + f];
      if (s >= S) continue;  // NA: counts nowhere
      const uint8_t* src = src_b + ((size_t)n * F + f) * C;
      if (src[0]) {
        for (int k = 0; k < K; ++k)
          if (cl_b[k * N + n]) atomicAdd(&counts[(k * ft + fl) * S + s], 1);
      }
      for (int c = 1; c < C; ++c) {
        if (!src[c]) continue;
        const int g = group_idx[(c - 1) * N + n];
        if (g < 0) continue;
        atomicAdd(&counts[((K + (c - 1) * G + g) * ft + fl) * S + s], 1);
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < rows * ft; i += blockDim.x) {
      const int r = i / ft;
      const int fl = i - r * ft;
      const int f = f0 + fl;
      const float* a = (r < K) ? conc_cl + (size_t)f * S
                               : conc_conf + ((size_t)(r - K) * F + f) * S;
      const int* cnt = counts + (r * ft + fl) * S;
      float sum_a = 0.f, n_tot = 0.f, series = 0.f;
      for (int s = 0; s < S; ++s) {
        const float as = a[s];
        const float cs = (float)cnt[s];
        sum_a += as;
        n_tot += cs;
        if (as > 0.f) series += lgammaf(cs + as) - lgammaf(as);
      }
      acc += lgammaf(sum_a) - lgammaf(n_tot + sum_a) + series;
    }
    __syncthreads();
  }

  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = (threadIdx.x < (blockDim.x >> 5)) ? warp_sums[threadIdx.x] : 0.f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (threadIdx.x == 0) out[b] = v;
  }
}

}  // namespace

extern "C" const char* sbt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int sbt_loglh(const void* clusters, const void* source, const void* feat_idx,
                         const void* group_idx, const void* conc_cl, const void* conc_conf,
                         void* out, int B, int K, int N, int F, int S, int C, int G,
                         void* stream) {
  const int rows = K + (C - 1) * G;
  const int row_bytes = rows * S * (int)sizeof(int);
  int f_tile = kSmemBudget / row_bytes;
  if (f_tile < 1) f_tile = 1;
  if (f_tile > F) f_tile = F;
  const int smem = row_bytes * f_tile;
  if (smem > kSmemBudget) {
    cudaError_t e = cudaFuncSetAttribute(loglh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B == 0) return 0;
  loglh_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(clusters), static_cast<const uint8_t*>(source),
      static_cast<const int8_t*>(feat_idx), static_cast<const int32_t*>(group_idx),
      static_cast<const float*>(conc_cl), static_cast<const float*>(conc_conf),
      static_cast<float*>(out), K, N, F, S, C, G, f_tile);
  return (int)cudaGetLastError();
}
