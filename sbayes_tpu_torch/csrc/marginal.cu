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
// Bound on an H100: by the definition of ops/marginal.py (bytes_moved,
// operations) memory: about 7.9 MB at B=1024, N=100, F=36, S=6, C=3 on the
// synthetic south_america-shaped data, about 2.4 us at 3.35 TB/s. The
// first version of this kernel (one warp per object, every lane gathering
// from the chain's tables in device memory) was held by those dependent
// gathers through L1/L2. This one is held by instruction throughput: B*N*F
// elements of about 100 instructions each, a third of them the one logf.
//
// Design: one block per chain (or per chain and object tile, below). The
// effect rows the block's objects read (p_eff, the confounder groups of its
// objects: group-sorted tiles, below) and the weights go to shared memory
// once per block (stage.cuh: bulk copies where the rows are 16-byte
// aligned, plain loads otherwise), so device memory and L2 see each row
// once per block instead of once per object. Lanes run over
// objects, 2^lpo_log2 neighbouring lanes share an object and split its
// features; the feature loop reads only shared memory and one coalesced
// byte of the feature-major state index (F, N). What belongs to the object
// (availabilities, membership, the offsets of its group rows) is read once
// into registers before the loop; the number of components is a template
// parameter (2, 3, 4; 0 = any, read in the loop) so those stay in registers:
// at the main shapes the kernel for any count takes 29.3 us where the one
// for 3 components takes 17.4 us (H100; PERF.md, section 6).
// Lanes that show the same state read one shared-memory word, other states
// fall into neighbouring banks. The two quotients of an element are a
// reciprocal and a product each (see `quotient`), the log is logf. A
// warp-shuffle sum joins the lanes of an object. Features are walked in
// tiles when the tables pass the shared-memory budget; the partial sums
// then accumulate in `out`.
//
// Object tiles: with fewer chains than SMs, one block per chain leaves most
// of the card idle (64 chains x 512 features: 56 us against a 1.5 us bound;
// at the scale shape, 16 chains x 10,000 objects x 5,000 features, 16 of
// 132 SMs). The wrapper then splits each chain's objects into tiles
// (ops/marginal.py: object_tile), and the grid is (chain, object tile):
// every block walks only its own objects, the lanes per object chosen for
// the tile. This follows the JAX kernel's own grid, (N // nb, t).
//
// Group-sorted tiles: a block stages only the confounder-group rows its own
// objects read. The wrapper lays the objects out once per model
// (ops/marginal.py: ObjectLayout): sorted by their group in the confounder
// with the most groups, with the state index and the group index copied in
// that order, and for each tile and confounder the range of groups its
// objects are in. A block stages those ranges (the universal confounder:
// one row, not Gmax), reads each object's availabilities and membership
// through the order and writes its result in place. With 215 families a
// tile of 243 sorted objects stages about 27 rows a feature instead of the
// padded 431, so the features fit 17 shared-memory tiles instead of 266 and
// the per-row staging stops setting the time. The tile boundaries follow
// the staged rows; per object the arithmetic, the lanes that split its
// features and their summation order within a tile are unchanged, so where
// the features fit one tile before and after (the south_america shapes) the
// results are the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage.cuh"

namespace {

// The most threads of a block, from which the lanes per object follow: with
// 256, 100 objects take 2 lanes each and fill 200 of 224 threads. 128 and
// 512 threads, and a feature loop unrolled once instead of 4 times, were
// each 9 to 24% slower at the main shapes (H100; PERF.md, section 6).
constexpr int kMaxThreads = 256;
// Dynamic shared memory of a block: what it gets without asking (the
// wrapper's budget for a feature tile, ops/marginal.py: SMEM_BUDGET), and the
// most it can ask for (48 KB and 227 KB, less 1 KB for the static part).
constexpr int kSmemBudget = 47 * 1024;
constexpr int kSmemMax = 226 * 1024;
constexpr float kTiny = 1e-35f;

// x / y for 1e-35 <= y < 2^126, which the TINY clamp and weights that sum to
// at most the number of components guarantee: a reciprocal and a product, 2
// ulp, in place of the 13 instructions of the correctly rounded quotient.
// Its error is below that of summing the logs in float32 in another order.
__device__ __forceinline__ float quotient(float x, float y) { return __fdividef(x, y); }

__host__ __device__ inline int align4(int x) { return (x + 3) & ~3; }

// Floats of shared memory for a tile of ft features with `rows` confounder
// rows (each table starts on 16 bytes). The wrapper picks ft from the same
// sum (ops/marginal.py: feature_tile).
__host__ __device__ inline int tile_floats(int ft, int S, int C, int rows, int E) {
  return align4(E * ft * S) + align4(rows * ft * S) + align4(ft * C);
}

template <bool RATIO, bool HEAT, bool TWO, int CT>
__global__ void __launch_bounds__(kMaxThreads)
marginal_kernel(const int8_t* __restrict__ feat_idx_t,  // (F, N) in sorted order, S = NA
                const int32_t* __restrict__ group_idx,  // (C-1, N) in sorted order, -1 = none
                const int32_t* __restrict__ order,      // (N,) the object at each sorted place
                const int32_t* __restrict__ tile_lo,    // (tiles, C-1) first group staged
                const int32_t* __restrict__ tile_base,  // (tiles, C) first staged row of each
                                                        // confounder, then the rows in all
                const float* __restrict__ p_eff,        // (B, E, F, S)
                const float* __restrict__ conf_eff,     // (B, C-1, G, F, S)
                const float* __restrict__ wh,           // (B, F, C)
                const float* __restrict__ hc,           // (B, N, C)
                const float* __restrict__ hcf,          // (B, N, C)
                const float* __restrict__ incl,         // (B, N)
                const float* __restrict__ inv_t,        // (B,) when HEAT
                float* __restrict__ out,                // (B, N) or (B, N, 2)
                int N, int F, int S, int C_any, int G, int f_tile, int rows, int lpo_log2,
                int obj_tile) {
  constexpr int E = (TWO || !RATIO) ? 2 : 1;
  constexpr int CR = CT > 0 ? CT : 1;  // registers per object and component
  const int C = CT > 0 ? CT : C_any;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;

  const int b = blockIdx.x;
  float* sp = smem;                                // (E, ft, S)
  float* sc = sp + align4(E * f_tile * S);         // (rows, ft, S): the tile's group rows
  float* sw = sc + align4(rows * f_tile * S);      // (ft, C)
  const int32_t* lo = tile_lo + (size_t)blockIdx.y * (C - 1);
  const int32_t* first_row = tile_base + (size_t)blockIdx.y * C;
  const float* pe = p_eff + (size_t)b * E * F * S;
  const float* ce = conf_eff + (size_t)b * (C - 1) * G * F * S;
  const float* w = wh + (size_t)b * F * C;
  const float it = HEAT ? inv_t[b] : 1.f;
  const int lpo = 1 << lpo_log2;
  const int n0 = blockIdx.y * obj_tile;  // the block's sorted places: [n0, n0 + obj_tile)
  const int items = min(obj_tile, N - n0) << lpo_log2;

  if (threadIdx.x == 0) sbt::barrier_init(&bar);
  __syncthreads();

  uint32_t parity = 0;
  for (int f0 = 0; f0 < F; f0 += f_tile, parity ^= 1u) {
    const int ft = min(f_tile, F - f0);
    const int fs = ft * S;
    if (f0 > 0) __syncthreads();  // every thread has left the previous tile
    uint32_t tx = sbt::stage_rows(sp, pe + (size_t)f0 * S, E, fs, (size_t)F * S, &bar);
    for (int c = 0; c < C - 1; ++c)  // confounder c's groups from lo[c], from its first row
      tx += sbt::stage_rows(sc + (size_t)first_row[c] * fs,
                            ce + ((size_t)(c * G + lo[c]) * F + f0) * S,
                            first_row[c + 1] - first_row[c], fs, (size_t)F * S, &bar);
    tx += sbt::stage_rows(sw, w + (size_t)f0 * C, 1, ft * C, (size_t)ft * C, &bar);
    if (threadIdx.x == 0) sbt::barrier_arrive_expect(&bar, tx);
    sbt::barrier_wait(&bar, parity);
    __syncthreads();

    for (int base = 0; base < items; base += blockDim.x) {
      const int item = base + threadIdx.x;
      const bool valid = item < items;
      const int i = n0 + (valid ? item >> lpo_log2 : 0);  // sorted place
      const int n = order[i];                             // object
      const int j = item & (lpo - 1);
      const size_t o = (size_t)b * N + n;
      const bool in_cluster = incl[o] > 0.5f;
      const float* hn = hc + o * C;
      const float* fn = hcf + o * C;
      float h_cur[CR], h_flip[CR];
      int g_row[CR];  // offset of the object's group row in sc, -1 = in no group
      if (CT > 0) {
#pragma unroll
        for (int c = 0; c < CR; ++c) {
          h_cur[c] = hn[c];
          h_flip[c] = fn[c];
          if (c > 0) {
            const int g = group_idx[(size_t)(c - 1) * N + i];
            g_row[c] = g < 0 ? -1 : (first_row[c - 1] + g - lo[c - 1]) * fs;
          }
        }
      }

      float acc0 = 0.f, acc1 = 0.f;
      // The lane's first feature and its steps: the state index (one byte per
      // object, neighbouring lanes on neighbouring bytes) and the cell row.
      const int8_t* fi = feat_idx_t + ((size_t)f0 + j) * N + i;
      const size_t fi_step = (size_t)N << lpo_log2;
      int cell0 = j * S;
      const int cell_step = S << lpo_log2;
#pragma unroll 4
      for (int fl = valid ? j : ft; fl < ft; fl += lpo, fi += fi_step, cell0 += cell_step) {
        const int s = *fi;
        const bool na = s >= S;
        const int cell = cell0 + (na ? 0 : s);
        float lh0a = sp[cell];
        if (HEAT) lh0a = expf(logf(fmaxf(lh0a, kTiny)) * it);
        float lh0b = lh0a;
        if (E == 2) {
          lh0b = sp[fs + cell];
          if (HEAT) lh0b = expf(logf(fmaxf(lh0b, kTiny)) * it);
        }
        if (na) lh0a = lh0b = 1.f;
        const float* wf = sw + fl * C;
        const float w0 = wf[0];
        const float a0 = (CT > 0 ? h_cur[0] : hn[0]) * w0;
        const float b0 = (CT > 0 ? h_flip[0] : fn[0]) * w0;
        float z_cur = a0, z_flip = b0;
        float s_cur = a0 * lh0a, s_flip = b0 * lh0b;
#pragma unroll
        for (int c = 1; c < (CT > 0 ? CT : C); ++c) {
          int row;
          if (CT > 0) {
            row = g_row[c];
          } else {
            const int g = group_idx[(size_t)(c - 1) * N + i];
            row = g < 0 ? -1 : (first_row[c - 1] + g - lo[c - 1]) * fs;
          }
          float lh = row < 0 ? 0.f : sc[row + cell];
          if (na) lh = 1.f;
          const float wc = wf[c];
          const float ac = (CT > 0 ? h_cur[c] : hn[c]) * wc;
          const float bc = (CT > 0 ? h_flip[c] : fn[c]) * wc;
          z_cur += ac;
          z_flip += bc;
          s_cur += ac * lh;
          s_flip += bc * lh;
        }
        if (RATIO) {
          const float r = quotient(s_cur, fmaxf(s_flip, kTiny)) *
                          quotient(z_flip, fmaxf(z_cur, kTiny));
          acc0 += logf(fmaxf(r, kTiny));
        } else {
          const float lh_cur = quotient(s_cur, fmaxf(z_cur, kTiny));
          const float lh_flip = quotient(s_flip, fmaxf(z_flip, kTiny));
          const float lh_with = in_cluster ? lh_cur : lh_flip;
          const float lh_without = in_cluster ? lh_flip : lh_cur;
          acc0 += logf(fmaxf(lh_without, kTiny));
          acc1 += logf(fmaxf(lh_with, kTiny));
        }
      }
      for (int off = lpo >> 1; off > 0; off >>= 1) {
        acc0 += __shfl_down_sync(0xffffffffu, acc0, off);
        if (!RATIO) acc1 += __shfl_down_sync(0xffffffffu, acc1, off);
      }
      if (valid && j == 0) {
        if (RATIO) {
          const float v = in_cluster ? acc0 : -acc0;
          out[o] = f0 > 0 ? out[o] + v : v;
        } else {
          out[2 * o] = f0 > 0 ? out[2 * o] + acc0 : acc0;
          out[2 * o + 1] = f0 > 0 ? out[2 * o + 1] + acc1 : acc1;
        }
      }
    }
  }
}

struct Args {
  const void *feat_idx_t, *group_idx, *order, *tile_lo, *tile_base, *p_eff, *conf_eff, *wh, *hc,
      *hcf, *incl, *inv_t;
  void* out;
  int B, N, F, S, C, G, obj_tile, f_tile, rows;
  cudaStream_t stream;
};

template <bool RATIO, bool HEAT, bool TWO, int CT>
int launch(const Args& a) {
  if (a.obj_tile < 1 || a.obj_tile > a.N || a.f_tile < 1 || a.f_tile > a.F || a.rows < 0)
    return (int)cudaErrorInvalidValue;
  constexpr int E = (TWO || !RATIO) ? 2 : 1;
  const int smem = tile_floats(a.f_tile, a.S, a.C, a.rows, E) * 4;
  auto kernel = marginal_kernel<RATIO, HEAT, TWO, CT>;
  if (smem > kSmemBudget) {  // one feature's rows alone pass the budget
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  // Lanes per object: the largest power of two that keeps the block's
  // objects within one pass of the block.
  int lpo_log2 = 0;
  while (lpo_log2 < 5 && ((long long)a.obj_tile << (lpo_log2 + 1)) <= kMaxThreads) ++lpo_log2;
  const long long items = (long long)a.obj_tile << lpo_log2;
  const int threads = items >= kMaxThreads ? kMaxThreads : (int)((items + 31) / 32) * 32;
  const dim3 grid(a.B, (a.N + a.obj_tile - 1) / a.obj_tile);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const int8_t*>(a.feat_idx_t), static_cast<const int32_t*>(a.group_idx),
      static_cast<const int32_t*>(a.order), static_cast<const int32_t*>(a.tile_lo),
      static_cast<const int32_t*>(a.tile_base), static_cast<const float*>(a.p_eff),
      static_cast<const float*>(a.conf_eff), static_cast<const float*>(a.wh),
      static_cast<const float*>(a.hc), static_cast<const float*>(a.hcf),
      static_cast<const float*>(a.incl),
      static_cast<const float*>(a.inv_t), static_cast<float*>(a.out), a.N, a.F, a.S, a.C, a.G,
      a.f_tile, a.rows, lpo_log2, a.obj_tile);
  return (int)cudaGetLastError();
}

template <bool RATIO, bool HEAT, bool TWO>
int launch_components(const Args& a) {
  switch (a.C) {
    case 2: return launch<RATIO, HEAT, TWO, 2>(a);
    case 3: return launch<RATIO, HEAT, TWO, 3>(a);
    case 4: return launch<RATIO, HEAT, TWO, 4>(a);
    default: return launch<RATIO, HEAT, TWO, 0>(a);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched). The objects in the
// sorted order of ops/marginal.py's layout: feat_idx_t, group_idx and order
// in that order, tile_lo / tile_base of its tiles of obj_tile objects (N:
// one block per chain); f_tile features a shared-memory tile, rows the most
// confounder rows a block stages.
extern "C" int sbt_marginal(const void* feat_idx_t, const void* group_idx, const void* order,
                            const void* tile_lo, const void* tile_base, const void* p_eff,
                            const void* conf_eff, const void* wh, const void* hc,
                            const void* hcf, const void* incl, const void* inv_t, void* out,
                            int B, int N, int F, int S, int C, int G, int ratio, int heat,
                            int two_eff, int obj_tile, int f_tile, int rows, void* stream) {
  if (B == 0 || N == 0) return 0;
  const Args a{feat_idx_t, group_idx, order, tile_lo, tile_base, p_eff, conf_eff, wh, hc, hcf,
               incl, inv_t, out, B, N, F, S, C, G, obj_tile, f_tile, rows,
               static_cast<cudaStream_t>(stream)};
  if (ratio) {
    if (heat) return two_eff ? launch_components<true, true, true>(a)
                             : launch_components<true, true, false>(a);
    return two_eff ? launch_components<true, false, true>(a)
                   : launch_components<true, false, false>(a);
  }
  return heat ? launch_components<false, true, true>(a)
              : launch_components<false, false, true>(a);
}
