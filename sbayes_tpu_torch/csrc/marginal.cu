// Cluster-membership marginal of every object, batched over chains.
//
// Replaces the TPU kernel sbayes_tpu/ops/pallas_marginal.py::_marginal_kernel
// (pl.pallas_call in make_pallas_marginal.marginal). For chain b, object n:
//
//   per feature f with observed state s (NA: every likelihood is 1)
//     lh_0      = p_eff[b, row, f, s]            (optionally ^invT, "heat")
//     lh_c      = conf_eff[b, c-1, g(c, n), f, s] (0 if n is in no group of c)
//     z_cur     = sum_c wh[b, f, c] * hc[b, n, c]
//     s_cur     = sum_c wh[b, f, c] * hc[b, n, c] * lh_c
//   and the same with hc_flip (cluster bit flipped) and effect row 1.
//
//   ratio:  out[b, n] = (2 incl - 1) * sum_f log(s_cur / s_flip * z_flip / z_cur)
//   else:   out[b, n, 0] = sum_f log(lh_without), out[b, n, 1] = sum_f log(lh_with)
//           where lh_with / lh_without pick s/z of the current or the flipped
//           availability by whether n is in the cluster now (incl).
//
// Every quotient and log argument is clamped to TINY = 1e-35, as on the TPU.
// Variants are template flags: RATIO, HEAT (lh_0^invT[b]) and TWO (two
// distinct effect rows; the non-ratio form always reads two rows).
//
// Design: one warp per (chain, object), lanes over features, a warp-shuffle
// sum; the int8 feature index (sentinel S = NA) selects the state, so no
// one-hot features are read. The per-chain effect tables are re-read by the
// N objects of the chain from L1/L2.
//
// Bound on an H100: memory. Each call must read, per chain, the conf_eff
// cells its objects show (the largest input; padding groups up to G and
// unseen states are never read), the p_eff cells, wh, hc, hc_flip and incl
// once and write the output: about 7.9 MB at B=1024, N=100, F=36, S=6, C=3
// on the synthetic south_america-shaped data, about 2.4 us at 3.35 TB/s
// (ops/marginal.py: bytes_moved).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTiny = 1e-35f;

template <bool RATIO, bool HEAT, bool TWO>
__global__ void marginal_kernel(const int8_t* __restrict__ feat_idx,    // (N, F), S = NA
                                const int32_t* __restrict__ group_idx,  // (C-1, N), -1 = none
                                const float* __restrict__ p_eff,        // (B, E, F, S)
                                const float* __restrict__ conf_eff,     // (B, C-1, G, F, S)
                                const float* __restrict__ wh,           // (B, F, C)
                                const float* __restrict__ hc,           // (B, N, C)
                                const float* __restrict__ hcf,          // (B, N, C)
                                const float* __restrict__ incl,         // (B, N)
                                const float* __restrict__ inv_t,        // (B,) when HEAT
                                float* __restrict__ out,                // (B, N) or (B, N, 2)
                                int B, int N, int F, int S, int C, int G) {
  constexpr int E = (TWO || !RATIO) ? 2 : 1;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * N) return;
  const int b = (int)(warp / N);
  const int n = (int)(warp - (long long)b * N);

  const float* pe = p_eff + (size_t)b * E * F * S;
  const float* ce = conf_eff + (size_t)b * (C - 1) * G * F * S;
  const float* w = wh + (size_t)b * F * C;
  const float* hn = hc + ((size_t)b * N + n) * C;
  const float* fn = hcf + ((size_t)b * N + n) * C;
  const bool in_cluster = incl[(size_t)b * N + n] > 0.5f;
  const float it = HEAT ? inv_t[b] : 1.f;

  float acc0 = 0.f, acc1 = 0.f;
  for (int f = lane; f < F; f += 32) {
    const int s = feat_idx[(size_t)n * F + f];
    const bool na = s >= S;
    float lh0a = 1.f, lh0b = 1.f;
    if (!na) {
      lh0a = pe[(size_t)f * S + s];
      if (HEAT) lh0a = expf(logf(fmaxf(lh0a, kTiny)) * it);
      if (E == 2) {
        lh0b = pe[((size_t)F + f) * S + s];
        if (HEAT) lh0b = expf(logf(fmaxf(lh0b, kTiny)) * it);
      } else {
        lh0b = lh0a;
      }
    }
    const float w0 = w[(size_t)f * C];
    float z_cur = hn[0] * w0, z_flip = fn[0] * w0;
    float s_cur = hn[0] * lh0a * w0, s_flip = fn[0] * lh0b * w0;
    for (int c = 1; c < C; ++c) {
      const int g = group_idx[(size_t)(c - 1) * N + n];
      float lh = 1.f;
      if (!na) lh = (g < 0) ? 0.f : ce[(((size_t)(c - 1) * G + g) * F + f) * S + s];
      const float wc = w[(size_t)f * C + c];
      z_cur += hn[c] * wc;
      z_flip += fn[c] * wc;
      s_cur += hn[c] * lh * wc;
      s_flip += fn[c] * lh * wc;
    }
    if (RATIO) {
      const float r = (s_cur / fmaxf(s_flip, kTiny)) * (z_flip / fmaxf(z_cur, kTiny));
      acc0 += logf(fmaxf(r, kTiny));
    } else {
      const float lh_cur = s_cur / fmaxf(z_cur, kTiny);
      const float lh_flip = s_flip / fmaxf(z_flip, kTiny);
      const float lh_with = in_cluster ? lh_cur : lh_flip;
      const float lh_without = in_cluster ? lh_flip : lh_cur;
      acc0 += logf(fmaxf(lh_without, kTiny));
      acc1 += logf(fmaxf(lh_with, kTiny));
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc0 += __shfl_down_sync(0xffffffffu, acc0, off);
    if (!RATIO) acc1 += __shfl_down_sync(0xffffffffu, acc1, off);
  }
  if (lane == 0) {
    const size_t o = (size_t)b * N + n;
    if (RATIO) {
      out[o] = in_cluster ? acc0 : -acc0;
    } else {
      out[2 * o] = acc0;
      out[2 * o + 1] = acc1;
    }
  }
}

template <bool RATIO, bool HEAT, bool TWO>
int launch(const void* feat_idx, const void* group_idx, const void* p_eff, const void* conf_eff,
           const void* wh, const void* hc, const void* hcf, const void* incl, const void* inv_t,
           void* out, int B, int N, int F, int S, int C, int G, cudaStream_t stream) {
  const long long threads = (long long)B * N * 32;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  marginal_kernel<RATIO, HEAT, TWO><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(feat_idx), static_cast<const int32_t*>(group_idx),
      static_cast<const float*>(p_eff), static_cast<const float*>(conf_eff),
      static_cast<const float*>(wh), static_cast<const float*>(hc),
      static_cast<const float*>(hcf), static_cast<const float*>(incl),
      static_cast<const float*>(inv_t), static_cast<float*>(out), B, N, F, S, C, G);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int sbt_marginal(const void* feat_idx, const void* group_idx, const void* p_eff,
                            const void* conf_eff, const void* wh, const void* hc,
                            const void* hcf, const void* incl, const void* inv_t, void* out,
                            int B, int N, int F, int S, int C, int G, int ratio, int heat,
                            int two_eff, void* stream) {
  if (B == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SBT_LAUNCH(R, H, T)                                                                  \
  return launch<R, H, T>(feat_idx, group_idx, p_eff, conf_eff, wh, hc, hcf, incl, inv_t, out, \
                         B, N, F, S, C, G, st)
  if (ratio) {
    if (heat) {
      if (two_eff) SBT_LAUNCH(true, true, true);
      SBT_LAUNCH(true, true, false);
    }
    if (two_eff) SBT_LAUNCH(true, false, true);
    SBT_LAUNCH(true, false, false);
  }
  if (heat) SBT_LAUNCH(false, true, true);
  SBT_LAUNCH(false, false, true);
#undef SBT_LAUNCH
}
