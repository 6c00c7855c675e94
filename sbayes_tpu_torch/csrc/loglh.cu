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
// Bound on an H100: by the definition of ops/loglh.py (bytes_moved,
// operations) memory: each chain reads the source of its observed cells and
// its memberships once, about 11 MB at B=1024, N=100, F=36, C=3, about
// 3.3 us at 3.35 TB/s. What the kernel spends is instruction throughput, not
// bytes. The first version built the counts with branches that split every
// warp three ways (one per component), then called lgammaf 2 S + 2 times
// for every (row, feature); lgammaf branches by the size of its argument,
// so a warp whose lanes hold different counts runs every branch in turn.
// Skipping zero counts or switching to a short product for small counts
// inside that pass does not help: a warp pays for the slowest of its lanes
// (measured: no faster than the first version).
//
// Design: one block per chain, and no lgamma at all. Both differences
// telescope over the integer counts:
//
//   lgamma(c + a) - lgamma(a) = sum_{i<c} log(a + i)
//   lgamma(sum a) - lgamma(n + sum a) = - sum_{i<n} log(sum a + i)
//
// so the observation that raises a cell's count from i to i + 1 adds
// log(a + i) - log(sum a + n_before), and the likelihood is a sum over the
// observed (object, feature) cells of the chain, each with the same cost:
//  * The chain's source slab (N x F x C bytes) goes to shared memory once
//    (stage.cuh: one bulk copy when it is 16-byte aligned, plain loads
//    otherwise) when it fits the budget beside the counts. A larger slab is
//    read where it lies, each byte once, by the same loop.
//  * Counts per cell and per (row, feature) are int32 in shared memory.
//    The atomicAdd that counts an observation returns the count before it,
//    which is the i of its term, so counts stay exact and every i < c is
//    used once, in whatever order the threads arrive.
//  * Lanes run over objects (a few neighbouring lanes share one and split
//    its features), as in the marginal kernel. The rows an object's
//    components count in are found once per object and kept in registers;
//    per feature a lane reads one coalesced byte of the feature-major state
//    index and its source bytes, picks the row, and all lanes take the
//    costly step (two atomics, two logs) together.
//  * Cells with count 0, empty rows and the padding groups up to Gmax cost
//    nothing: no observation reaches them.
//  * What depends on the model only comes precomputed from the host: the
//    concentrations of the cluster prior and of every group in one table,
//    with sum_s a beside them (model/constants.py: conc_table).
//  * The terms are summed in 64-bit fixed point (2^-30), so the result does
//    not depend on the order in which threads took the counts: the same
//    inputs give the same bits. A block reduction ends with one float per
//    chain.
//  * Features are walked in tiles when the counts pass the shared-memory
//    budget. One feature's counts have to fit a block's shared memory
//    (about 57,800 cells of rows x (S + 1)); the entry point refuses more.
//    Tiles are independent (a count belongs to one feature), so with more
//    than one tile the grid is (chain, tile): each block counts one tile and
//    writes its fixed-point sum, and a second kernel adds a chain's sums.
//    Integer sums do not depend on their order, so the bits are those of
//    one block walking all tiles; at the scale shape (16 chains, 63 tiles)
//    that is 1,008 blocks where one block per chain kept 16 of 132 SMs busy.
//  * The source comes in either form of the chain state (template PACKED):
//    the bool one-hot (B, N, F, C), C bytes a cell scanned for the set
//    component, or the packed int8 component index (B, N, F), one byte a
//    cell and no scan; the sentinel C (NA / no component) counts nothing.
//    At the scale shape (10,000 x 5,000 x 5, C = 3) the packed source is
//    50 MB a chain against 150 MB; the counts of 25 rows leave about 80
//    features per tile, so the source is read where it lies.
//
// Two more entry points serve the object-axis split (parallel/mesh.py),
// where one shard holds a block of the objects. The i-th observation of a
// cell adds a term that depends on the i - 1 before it, wherever they lie,
// so the likelihood itself does not split over objects; its counts do.
//  * sbt_loglh_counts: the same kernel (template COUNTS) on one block of
//    objects, with the block's feature index and groups, counts the
//    observations and writes each tile's integer counts out as float32
//    (B, K, F, S) and (B, C-1, G, F, S); no logs.
//  * sbt_loglh_from_counts: the terms of the counts summed over the blocks.
//    A cell of count c adds log(a + i) for i < c and its row of total n
//    subtracts log(sum a + i) for i < n: the very terms of the fused kernel,
//    computed the same way and summed in the same fixed point, so the
//    result equals the fused kernel's bit for bit, however the objects were
//    split. One warp takes a (chain, row) and 32 features; its lanes split
//    the i of each cell, so a count of thousands costs a warp c / 32 turns.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage.cuh"

namespace {

constexpr int kThreads = 256;
// Dynamic shared memory of a block: what it gets without asking, and the
// most it can ask for (48 KB and 227 KB, less 1 KB for the static part).
constexpr int kSmemBudget = 47 * 1024;
constexpr int kSmemMax = 226 * 1024;
constexpr float kFixedPoint = 1073741824.f;  // 2^30

__host__ __device__ inline long long align16(long long x) { return (x + 15) & ~15LL; }

struct Tiling {
  int f_tile;   // features per tile of counts
  int smem;     // dynamic shared memory in bytes, -1: one feature's counts do not fit a block
  bool staged;  // the chain's source slab lies behind the counts
};

// All features in one tile, with the source slab behind the counts, when
// both fit the budget. Else the counts alone are tiled, as many features as
// the budget holds, and the source is read from device memory. One
// feature's counts may pass the budget up to what a block can have at all.
Tiling tiling(int K, int N, int F, int S, int C, int G, bool packed) {
  const long long count_bytes = (long long)(K + (C - 1) * G) * (S + 1) * 4;  // per feature
  const long long both = align16(count_bytes * F) + (long long)N * F * (packed ? 1 : C);
  if (both <= kSmemBudget) return Tiling{F, (int)both, true};
  long long ft = kSmemBudget / count_bytes;
  if (ft < 1) ft = 1;
  if (ft > F) ft = F;
  const long long smem = count_bytes * ft;
  return Tiling{(int)ft, smem > kSmemMax ? -1 : (int)smem, false};
}

// The logs come from the special-function unit (__logf: within 2^-21.41 of
// the log for arguments in [0.5, 2], within 3 ulp elsewhere, exactly 0 at
// 1); logf (1 ulp) costs 30 instructions more per log and a quarter of the
// kernel's time. The total takes some 7,000 logs of both signs per chain;
// with either, it lands within 2 ulp of the plain version's float32 total
// at the main shapes (H100; PERF.md, section 6).
__device__ __forceinline__ float term_log(float x) { return __logf(x); }

// One observation joins state s of a row: returns its term
// log(a + c_before) - log(sum a + n_before) in fixed point. An excluded
// state (a <= 0) adds no log of its own but counts towards n, as in the sum
// of lgamma differences. `row` points at the row's S cell counts followed
// by their sum, `conc` at its S concentrations followed by their sum.
__device__ __forceinline__ long long observe(int* row, const float* __restrict__ conc, int s,
                                             int S) {
  const int c_before = atomicAdd(row + s, 1);
  const int n_before = atomicAdd(row + S, 1);
  const float a = __ldg(conc + s);
  const float sum_a = __ldg(conc + S);
  // Both logs are taken and then selected, so that the lanes stay together.
  // Each goes to fixed point on its own: which n_before meets which c_before
  // depends on the order of the threads, the two sets of logs do not.
  const float log_cell = a > 0.f ? term_log(a + (float)c_before) : 0.f;
  const float log_row = sum_a > 0.f ? term_log(sum_a + (float)n_before) : 0.f;
  return __float2ll_rn(log_cell * kFixedPoint) - __float2ll_rn(log_row * kFixedPoint);
}

// One observation joins state s of a row: its term (observe), or with
// COUNTS its count alone.
template <bool COUNTS>
__device__ __forceinline__ long long take(int* row, const float* __restrict__ conc, int s, int S) {
  if (COUNTS) {
    atomicAdd(row + s, 1);
    return 0;
  }
  return observe(row, conc, s, S);
}

// The row of the cluster that holds object n (-1: none); sets *many when
// several do.
__device__ __forceinline__ int cluster_of(const uint8_t* __restrict__ cl_b, int K, int N, int n,
                                          bool* many) {
  int t = -1;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    if (!cl_b[k * N + n]) continue;
    *many |= t >= 0;
    t = k;
  }
  return t;
}

// CT: the number of components when it is 2, 3 or 4 (what belongs to an
// object stays in registers, the scan of the source bytes unrolls), 0 for
// any other; at the main shapes the kernel for any count takes 31.7 us where
// the one for 3 components takes 21.9 us (H100; PERF.md, section 6).
// STAGED: the source slab is copied to shared memory first (then
// f_tile = F), else it is read from device memory. PACKED: the source is the
// int8 component index (B, N, F), sentinel C, else the bool one-hot.
// COUNTS: write each tile's counts to cl_out / conf_out instead of the
// likelihood (out and partial unused).
template <int CT, bool STAGED, bool PACKED, bool COUNTS>
__global__ void __launch_bounds__(kThreads)
loglh_kernel(const uint8_t* __restrict__ clusters,    // (B, K, N)
             const uint8_t* __restrict__ source,      // (B, N, F, C) or packed (B, N, F)
             const int8_t* __restrict__ feat_idx_t,   // (F, N), S = NA
             const int32_t* __restrict__ group_idx,   // (C-1, N), -1 = none
             const float* __restrict__ conc_table,    // (R, F, S + 1): a per state, then sum_s a
             float* __restrict__ out,                 // (B,)
             long long* __restrict__ partial,         // (B, gridDim.y) when gridDim.y > 1
             float* __restrict__ cl_out,              // (B, K, F, S) with COUNTS
             float* __restrict__ conf_out,            // (B, C-1, G, F, S) with COUNTS
             int K, int N, int F, int S, int C_any, int G, int f_tile, int lpo_log2) {
  // R = 1 + (C-1) G model rows: the cluster prior (shared by the K clusters),
  // then the groups of each confounder. Offsets within a chain and within
  // the table are ints: the entry point refuses shapes that pass 2^31.
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ long long warp_sums[kThreads / 32];
  constexpr int CR = CT > 0 ? CT : 1;  // registers per object and component
  const int C = CT > 0 ? CT : C_any;
  const int CB = PACKED ? 1 : C;  // source bytes per (object, feature) cell
  const int lpo = 1 << lpo_log2;
  const int items = N << lpo_log2;
  const int b = blockIdx.x;
  const int rows = K + (C - 1) * G;
  const int S1 = S + 1;
  int* counts = reinterpret_cast<int*>(smem);  // (rows, ft, S + 1): cells, then their sum n
  uint8_t* ssrc = smem + align16(4LL * rows * f_tile * S1);  // (N, F, CB) when STAGED
  const uint8_t* cl_b = clusters + (size_t)b * K * N;
  const uint8_t* src_b = source + (size_t)b * N * F * CB;
  const uint8_t* src_rows = STAGED ? ssrc : src_b;  // where the loop reads the source

  if (STAGED) {
    if (threadIdx.x == 0) sbt::barrier_init(&bar);
    __syncthreads();
    const uint32_t tx = sbt::stage_rows(ssrc, src_b, 1, N * F * CB, (size_t)N * F * CB, &bar);
    if (threadIdx.x == 0) sbt::barrier_arrive_expect(&bar, tx);
  }

  long long acc = 0;
  const int f_first = blockIdx.y * f_tile;
  for (int f0 = f_first; f0 < F; f0 += f_tile * gridDim.y) {
    const int ft = min(f_tile, F - f0);
    if (f0 > f_first) __syncthreads();  // every thread has left the previous tile
    for (int i = threadIdx.x; i < rows * ft * S1; i += blockDim.x) counts[i] = 0;
    if (STAGED) sbt::barrier_wait(&bar, 0);  // one tile: the slab arrives once
    __syncthreads();

    // Lanes run over objects, 2^lpo_log2 neighbouring lanes share an object
    // and split its features. The rows an object's components count in (its
    // cluster, its group of each confounder) are found once per object; an
    // observation is attributed to one component, so per feature a lane
    // only picks among them and takes the one costly step. Observations
    // with more targets (sources that are not one-hot, overlapping
    // clusters) are counted too, in a loop over all rows that such an
    // observation alone walks.
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
      const int n = item >> lpo_log2;
      const int j = item & (lpo - 1);
      int row_of[CR], conc_of[CR];  // per component: count row (-1: none), offset of its table row
      bool many_clusters = false;
      if (CT > 0) {
        row_of[0] = cluster_of(cl_b, K, N, n, &many_clusters);
        conc_of[0] = 0;
#pragma unroll
        for (int c = 1; c < CR; ++c) {
          const int g = group_idx[(c - 1) * N + n];
          row_of[c] = g < 0 ? -1 : K + (c - 1) * G + g;
          conc_of[c] = (1 + (c - 1) * G + g) * F * S1;
        }
      }
      const int8_t* fi = feat_idx_t + (f0 + j) * N + n;
      const uint8_t* src = src_rows + ((size_t)n * F + f0 + j) * CB;
      for (int fl = j; fl < ft; fl += lpo, fi += N << lpo_log2, src += CB << lpo_log2) {
        const int s = *fi;
        int first = 0, n_set = 0;
        if (PACKED) {
          first = *reinterpret_cast<const int8_t*>(src);
          n_set = first >= 0 && first < C;
        } else {
#pragma unroll
          for (int c = (CT > 0 ? CT : C) - 1; c >= 0; --c) {
            if (src[c]) {
              first = c;
              ++n_set;
            }
          }
        }
        if (s >= S || n_set == 0) continue;  // NA, or attributed to nothing: counts nowhere
        int t, conc;  // the target row and the offset of its concentrations
        bool many = n_set > 1;
        if (CT > 0) {
          t = row_of[0];
          conc = conc_of[0];
#pragma unroll
          for (int c = 1; c < CR; ++c) {
            if (first == c) {
              t = row_of[c];
              conc = conc_of[c];
            }
          }
          many |= many_clusters && first == 0;
        } else if (first == 0) {
          t = cluster_of(cl_b, K, N, n, &many);
          conc = 0;
        } else {
          const int g = group_idx[(first - 1) * N + n];
          t = g < 0 ? -1 : K + (first - 1) * G + g;
          conc = (1 + (first - 1) * G + g) * F * S1;
        }
        const int f = f0 + fl;
        if (!many) {
          if (t < 0) continue;  // its component has no row for this object
          acc += take<COUNTS>(counts + (t * ft + fl) * S1, conc_table + conc + f * S1, s, S);
          continue;
        }
        for (int r = 0; r < rows; ++r) {
          const int c = r < K ? 0 : 1 + (r - K) / G;
          const bool hit = r < K ? cl_b[r * N + n] != 0
                                 : group_idx[(c - 1) * N + n] == (r - K) % G;
          if (!hit || !(PACKED ? first == c : src[c] != 0)) continue;
          const int model_row = r < K ? 0 : r - K + 1;
          acc += take<COUNTS>(counts + (r * ft + fl) * S1,
                              conc_table + (model_row * F + f) * S1, s, S);
        }
      }
    }
    if (COUNTS) {  // the tile's counts, as float32, to the chain's count tensors
      __syncthreads();
      const int cells = rows * ft * S;
      for (int i = threadIdx.x; i < cells; i += blockDim.x) {
        const int r = i / (ft * S);
        const int fl = (i - r * ft * S) / S;
        const int s = i - (r * ft + fl) * S;
        const float v = (float)counts[(r * ft + fl) * S1 + s];
        if (r < K)
          cl_out[(((size_t)b * K + r) * F + f0 + fl) * S + s] = v;
        else
          conf_out[(((size_t)b * (rows - K) + r - K) * F + f0 + fl) * S + s] = v;
      }
    }
  }
  if (COUNTS) return;

  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    long long v = (threadIdx.x < (blockDim.x >> 5)) ? warp_sums[threadIdx.x] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (threadIdx.x == 0) {
      if (gridDim.y == 1) out[b] = (float)((double)v / (double)kFixedPoint);
      else partial[(size_t)b * gridDim.y + blockIdx.y] = v;
    }
  }
}

// The chain's likelihood from the fixed-point sums of its tiles.
__global__ void loglh_finish(const long long* __restrict__ partial, float* __restrict__ out,
                             int B, int tiles) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  long long v = 0;
  for (int t = 0; t < tiles; ++t) v += partial[(size_t)b * tiles + t];
  out[b] = (float)((double)v / (double)kFixedPoint);
}

constexpr int kFeaturesPerWarp = 32;

// The likelihood from counts summed over object blocks: warp w takes chain
// b, row r (the K clusters, then the (C-1) G groups) and 32 features; per
// cell its lanes take i = lane, lane + 32, ... of the cell's terms, then of
// the row's. One 64-bit atomic per warp adds its fixed-point sum to the
// chain's (integer sums: any order gives the same bits).
__global__ void __launch_bounds__(kThreads)
loglh_from_counts_kernel(const float* __restrict__ cl,          // (B, K, F, S)
                         const float* __restrict__ conf,        // (B, C-1, G, F, S)
                         const float* __restrict__ conc_table,  // (R, F, S + 1)
                         unsigned long long* __restrict__ sums,  // (B,), zeroed
                         int B, int K, int F, int S, int rows) {
  const int lane = threadIdx.x & 31;
  const int chunks = (F + kFeaturesPerWarp - 1) / kFeaturesPerWarp;
  const long long n_warps = (long long)B * rows * chunks;
  const long long stride = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long w = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); w < n_warps;
       w += stride) {
    const int chunk = (int)(w % chunks);
    const int r = (int)((w / chunks) % rows);
    const int b = (int)(w / ((long long)chunks * rows));
    const float* c_row = r < K ? cl + ((size_t)b * K + r) * F * S
                               : conf + ((size_t)b * (rows - K) + r - K) * F * S;
    const float* conc_row = conc_table + (size_t)(r < K ? 0 : 1 + r - K) * F * (S + 1);
    long long acc = 0;
    const int f_end = min(F, (chunk + 1) * kFeaturesPerWarp);
    for (int f = chunk * kFeaturesPerWarp; f < f_end; ++f) {
      const float* c = c_row + (size_t)f * S;
      const float* conc = conc_row + (size_t)f * (S + 1);
      int n = 0;
      for (int s = 0; s < S; ++s) {
        const int cs = (int)c[s];
        n += cs;
        const float a = __ldg(conc + s);
        if (a > 0.f)
          for (int i = lane; i < cs; i += 32)
            acc += __float2ll_rn(term_log(a + (float)i) * kFixedPoint);
      }
      const float sum_a = __ldg(conc + S);
      if (sum_a > 0.f)
        for (int i = lane; i < n; i += 32)
          acc -= __float2ll_rn(term_log(sum_a + (float)i) * kFixedPoint);
    }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0 && acc != 0) atomicAdd(sums + b, (unsigned long long)acc);
  }
}

__global__ void loglh_sums_to_float(const unsigned long long* __restrict__ sums,
                                    float* __restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) out[b] = (float)((double)(long long)sums[b] / (double)kFixedPoint);
}

template <int CT, bool STAGED, bool PACKED, bool COUNTS>
int launch(const void* clusters, const void* source, const void* feat_idx_t,
           const void* group_idx, const void* conc_table, void* out, void* partial, void* cl_out,
           void* conf_out, int B, int K, int N, int F, int S, int C, int G, const Tiling& t,
           cudaStream_t stream) {
  auto kernel = loglh_kernel<CT, STAGED, PACKED, COUNTS>;
  if (t.smem > kSmemBudget) {  // one feature's counts alone pass the budget
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         t.smem);
    if (e != cudaSuccess) return (int)e;
  }
  // Lanes per object: the largest power of two that keeps the chain's
  // objects within one pass of the block.
  int lpo_log2 = 0;
  while (lpo_log2 < 5 && ((long long)N << (lpo_log2 + 1)) <= kThreads) ++lpo_log2;
  const long long items = (long long)N << lpo_log2;
  const int threads = items >= kThreads ? kThreads : (int)((items + 31) / 32) * 32;
  const int tiles = (F + t.f_tile - 1) / t.f_tile;
  kernel<<<dim3(B, tiles), threads, t.smem, stream>>>(
      static_cast<const uint8_t*>(clusters), static_cast<const uint8_t*>(source),
      static_cast<const int8_t*>(feat_idx_t), static_cast<const int32_t*>(group_idx),
      static_cast<const float*>(conc_table), static_cast<float*>(out),
      static_cast<long long*>(partial), static_cast<float*>(cl_out),
      static_cast<float*>(conf_out), K, N, F, S, C, G, t.f_tile, lpo_log2);
  if (!COUNTS && tiles > 1)
    loglh_finish<<<(B + 255) / 256, 256, 0, stream>>>(static_cast<const long long*>(partial),
                                                       static_cast<float*>(out), B, tiles);
  return (int)cudaGetLastError();
}

template <int CT, bool PACKED, bool COUNTS>
int launch_staging(const void* clusters, const void* source, const void* feat_idx_t,
                   const void* group_idx, const void* conc_table, void* out, void* partial,
                   void* cl_out, void* conf_out, int B, int K, int N, int F, int S, int C, int G,
                   const Tiling& t, cudaStream_t st) {
  return t.staged
             ? launch<CT, true, PACKED, COUNTS>(clusters, source, feat_idx_t, group_idx,
                                                conc_table, out, partial, cl_out, conf_out, B, K,
                                                N, F, S, C, G, t, st)
             : launch<CT, false, PACKED, COUNTS>(clusters, source, feat_idx_t, group_idx,
                                                 conc_table, out, partial, cl_out, conf_out, B,
                                                 K, N, F, S, C, G, t, st);
}

// Both the fused likelihood and the counts of one object block.
template <bool COUNTS>
int launch_any(const void* clusters, const void* source, const void* feat_idx_t,
               const void* group_idx, const void* conc_table, void* out, void* partial,
               void* cl_out, void* conf_out, int B, int K, int N, int F, int S, int C, int G,
               int packed, cudaStream_t st) {
  const long long limit = 1LL << 31;
  if ((long long)N * F * C >= limit || (1LL + (long long)(C - 1) * G) * F * (S + 1) >= limit)
    return (int)cudaErrorInvalidValue;
  const Tiling t = tiling(K, N, F, S, C, G, packed != 0);
  if (t.smem < 0 || (!COUNTS && t.f_tile < F && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
#define SBT_LAUNCH(CT)                                                                       \
  return packed ? launch_staging<CT, true, COUNTS>(clusters, source, feat_idx_t, group_idx,    \
                                                   conc_table, out, partial, cl_out, conf_out, \
                                                   B, K, N, F, S, C, G, t, st)                 \
                : launch_staging<CT, false, COUNTS>(clusters, source, feat_idx_t, group_idx,   \
                                                    conc_table, out, partial, cl_out,          \
                                                    conf_out, B, K, N, F, S, C, G, t, st)
  switch (C) {
    case 2: SBT_LAUNCH(2);
    case 3: SBT_LAUNCH(3);
    case 4: SBT_LAUNCH(4);
    default: SBT_LAUNCH(0);
  }
#undef SBT_LAUNCH
}

}  // namespace

// Features per shared-memory tile for these shapes (all of them = no tiling).
extern "C" int sbt_loglh_feature_tile(int K, int N, int F, int S, int C, int G, int packed) {
  return tiling(K, N, F, S, C, G, packed != 0).f_tile;
}

// Returns the cudaError_t of the launch (0 = launched). packed: the source
// is the int8 (B, N, F) component index, else the bool (B, N, F, C).
// partial: B x ceil(F / tile) int64 of scratch when the features take more
// than one tile (sbt_loglh_feature_tile), else unused.
extern "C" int sbt_loglh(const void* clusters, const void* source, const void* feat_idx_t,
                         const void* group_idx, const void* conc_table, void* out, void* partial,
                         int B, int K, int N, int F, int S, int C, int G, int packed,
                         void* stream) {
  return launch_any<false>(clusters, source, feat_idx_t, group_idx, conc_table, out, partial,
                           nullptr, nullptr, B, K, N, F, S, C, G, packed,
                           static_cast<cudaStream_t>(stream));
}

// The integer counts of one block of N objects (its clusters (B, K, N), its
// source, its feat_idx_t (F, N) and group_idx (C-1, N)) as float32:
// cl_out (B, K, F, S) and conf_out (B, C-1, G, F, S), every cell written.
extern "C" int sbt_loglh_counts(const void* clusters, const void* source, const void* feat_idx_t,
                                const void* group_idx, void* cl_out, void* conf_out, int B, int K,
                                int N, int F, int S, int C, int G, int packed, void* stream) {
  return launch_any<true>(clusters, source, feat_idx_t, group_idx, nullptr, nullptr, nullptr,
                          cl_out, conf_out, B, K, N, F, S, C, G, packed,
                          static_cast<cudaStream_t>(stream));
}

// The likelihood (B,) from counts cl (B, K, F, S) and conf (B, C-1, G, F, S)
// (float32 holding integers), with the concentrations of conc_table; sums:
// B int64 of scratch.
extern "C" int sbt_loglh_from_counts(const void* cl, const void* conf, const void* conc_table,
                                     void* out, void* sums, int B, int K, int F, int S, int C,
                                     int G, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(sums, 0, sizeof(unsigned long long) * B, st);
  if (e != cudaSuccess) return (int)e;
  const int rows = K + (C - 1) * G;
  const long long warps =
      (long long)B * rows * ((F + kFeaturesPerWarp - 1) / kFeaturesPerWarp);
  const long long blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  loglh_from_counts_kernel<<<(unsigned)(blocks < (1LL << 20) ? blocks : (1LL << 20)), kThreads,
                             0, st>>>(
      static_cast<const float*>(cl), static_cast<const float*>(conf),
      static_cast<const float*>(conc_table), static_cast<unsigned long long*>(sums), B, K, F, S,
      rows);
  loglh_sums_to_float<<<(B + 255) / 256, 256, 0, st>>>(
      static_cast<const unsigned long long*>(sums), static_cast<float*>(out), B);
  return (int)cudaGetLastError();
}
