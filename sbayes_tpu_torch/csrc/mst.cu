// Batched masked Prim: [total, n_edges, max_edge] of the minimum spanning
// tree over each mask's members in a dense (N, N) float32 cost matrix.
//
// Replaces no TPU kernel: the JAX package computes its Prim in plain JAX
// (sbayes_tpu/ops/mst.py, cluster_mst_stats_prim and the gather form
// cluster_mst_edge_costs), outside any Pallas kernel. It was added because
// the port's plain version (ops/mst.py::_prim) is a host loop: five launches
// per iteration, one iteration per member of the batch's largest cluster,
// whose size it reads to the host first (a sync). Here every mask runs its
// own loop, to its own size, on the card.
//
// Semantics, exactly _prim's: start at the mask's first member; each
// iteration takes the candidate nearest the tree (the arg-min of the
// distances, the smallest index on ties), adds its edge and relaxes the
// distances with its cost row. A mask of size <= 1 gives (0, 0, 0); the
// first infinite minimum ends the tree (a cut no finite edge crosses), and
// no later edge counts. The total is added in edge order (_prim sums the
// edges pairwise, so the two may differ in the last place); the edge count
// and the longest edge are exact.
//
// Bound on an H100: latency. A mask of m members is a chain of m - 1
// dependent steps, each an arg-min over N distances and a read of one cost
// row (4N bytes; at N = 100 the whole matrix is 40 KB and stays in L2).
// Bytes and operations are far below the card's rates (chip_smoke.py:
// update_geo_cost, "bound"); the time is m - 1 round trips of a row read
// and a reduction.
//
// Design: the distances and the open flags (member, not yet in the tree)
// stay in registers; each thread owns the objects t, t + T, t + 2T, ... (T
// threads to a mask), so a cost row is read with coalesced, read-only loads
// and only at the open objects. N <= 1024: one warp per mask, the arg-min a
// shuffle reduction with no __syncthreads (4 masks to a block). Larger N
// (up to 32 x 1024): one block of 1024 threads per mask, the warps' arg-mins
// joined through shared memory, one barrier per iteration (two buffers, so
// no warp overwrites a partial another still reads). Registers rather than
// shared memory hold the distances because every distance is only ever
// touched by its own thread. The values per thread (VPL, a power of two) are
// a template parameter chosen from N, so the arrays stay in registers.
//
// Update form (idx0 != nullptr): the tasks are the (b, k) rows of a (B, K)
// batch of clusters; a row whose k is idx0[b] or idx1[b] is recomputed from
// its mask, every other row is copied from agg_in. So the carried geo
// aggregates of a proposal take one launch, with no copy before it.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBigIndex = 0x7fffffff;
constexpr int kWarpTasksPerBlock = 4;    // warp path: masks per block
constexpr int kBlockWarps = 32;          // block path: warps per mask
constexpr int kMaxVpl = 32;              // values per thread (bits of `open`); the most
                                         // objects, 32 x 1024, is ops/mst.py: MAX_OBJECTS

// (w, j) <- the smaller of (w, j) and (w2, j2): by cost, then by index.
__device__ __forceinline__ void take_smaller(float& w, int& j, float w2, int j2) {
  if (w2 < w || (w2 == w && j2 < j)) {
    w = w2;
    j = j2;
  }
}

__device__ __forceinline__ void warp_argmin(float& w, int& j) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float w2 = __shfl_xor_sync(kFull, w, off);
    const int j2 = __shfl_xor_sync(kFull, j, off);
    take_smaller(w, j, w2, j2);
  }
}

// WARPS warps work on one mask: 1 (the warp path) or kBlockWarps.
template <int VPL, int WARPS>
__global__ void __launch_bounds__(WARPS == 1 ? kWarpTasksPerBlock * kWarp : WARPS * kWarp)
mst_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ masks,
           const int64_t* __restrict__ idx0, const int64_t* __restrict__ idx1,
           const float* __restrict__ agg_in, float* __restrict__ out, int n_tasks, int K,
           int N) {
  constexpr int T = WARPS * kWarp;       // threads on one mask: the stride of its objects
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int task = WARPS == 1 ? blockIdx.x * kWarpTasksPerBlock + warp : blockIdx.x;
  const int t = WARPS == 1 ? lane : threadIdx.x;
  if (task >= n_tasks) return;           // whole warps (warp path) or the whole block
  float* dst = out + (size_t)task * 3;
  if (idx0 != nullptr) {
    const int b = task / K;
    const int64_t k = task - b * K;
    if (k != idx0[b] && (idx1 == nullptr || k != idx1[b])) {
      if (t < 3) dst[t] = agg_in[(size_t)task * 3 + t];
      return;
    }
  }

  __shared__ float s_w[2][WARPS];
  __shared__ int s_j[2][WARPS];
  __shared__ int s_size[WARPS];

  // Members, their count and the first of them.
  const uint8_t* mask = masks + (size_t)task * N;
  uint32_t open = 0;
  int first = kBigIndex;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int i = t + v * T;
    if (i < N && mask[i]) {
      open |= 1u << v;
      first = min(first, i);
    }
  }
  int size = __popc(open);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    size += __shfl_xor_sync(kFull, size, off);
    first = min(first, __shfl_xor_sync(kFull, first, off));
  }
  if constexpr (WARPS > 1) {
    if (lane == 0) {
      s_size[warp] = size;
      s_j[0][warp] = first;
    }
    __syncthreads();
    size = lane < WARPS ? s_size[lane] : 0;
    first = lane < WARPS ? s_j[0][lane] : kBigIndex;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      size += __shfl_xor_sync(kFull, size, off);
      first = min(first, __shfl_xor_sync(kFull, first, off));
    }
  }

  float total = 0.f, max_edge = 0.f;
  int n_edges = 0;
  if (size > 1) {
    // The first member starts the tree.
    float d[VPL];
    const float* row = cost + (size_t)first * N;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int i = t + v * T;
      if (i == first) open &= ~(1u << v);
      d[v] = (open >> v) & 1u ? __ldg(row + i) : CUDART_INF_F;
    }
    for (int it = 1; it < size; ++it) {
      float w = CUDART_INF_F;
      int j = kBigIndex;
#pragma unroll
      for (int v = 0; v < VPL; ++v) take_smaller(w, j, d[v], t + v * T);
      warp_argmin(w, j);
      if constexpr (WARPS > 1) {
        const int p = it & 1;
        if (lane == 0) {
          s_w[p][warp] = w;
          s_j[p][warp] = j;
        }
        __syncthreads();
        w = lane < WARPS ? s_w[p][lane] : CUDART_INF_F;
        j = lane < WARPS ? s_j[p][lane] : kBigIndex;
        warp_argmin(w, j);
      }
      if (!(fabsf(w) < CUDART_INF_F)) break;  // not finite; the same on every thread
      total += w;
      n_edges += 1;
      max_edge = fmaxf(max_edge, w);
      row = cost + (size_t)j * N;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int i = t + v * T;
        if (i == j) open &= ~(1u << v);
        d[v] = (open >> v) & 1u ? fminf(d[v], __ldg(row + i)) : CUDART_INF_F;
      }
    }
  }
  if (t == 0) {
    dst[0] = total;
    dst[1] = (float)n_edges;
    dst[2] = max_edge;
  }
}

template <int WARPS>
cudaError_t launch(int vpl, const float* cost, const uint8_t* masks, const int64_t* idx0,
                   const int64_t* idx1, const float* agg_in, float* out, int n_tasks, int K,
                   int N, cudaStream_t stream) {
  const int threads = WARPS == 1 ? kWarpTasksPerBlock * kWarp : WARPS * kWarp;
  const int blocks = WARPS == 1 ? (n_tasks + kWarpTasksPerBlock - 1) / kWarpTasksPerBlock
                                : n_tasks;
#define SBT_MST_CASE(V)                                                                     \
  case V:                                                                                   \
    mst_kernel<V, WARPS><<<blocks, threads, 0, stream>>>(cost, masks, idx0, idx1, agg_in,  \
                                                          out, n_tasks, K, N);             \
    break;
  switch (vpl) {
    SBT_MST_CASE(1)
    SBT_MST_CASE(2)
    SBT_MST_CASE(4)
    SBT_MST_CASE(8)
    SBT_MST_CASE(16)
    SBT_MST_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef SBT_MST_CASE
  return cudaGetLastError();
}

// The smallest power of two >= ceil(n / per).
int values_per_thread(int n, int per) {
  const int need = (n + per - 1) / per;
  int v = 1;
  while (v < need) v *= 2;
  return v;
}

}  // namespace

// n_tasks masks of N objects (uint8 rows of `masks`, n_tasks = B * K), the
// (N, N) cost matrix, out (n_tasks, 3). idx0 == nullptr: every row is
// computed (agg_in, idx1 unused). Else idx0 / idx1 (B,) int64 (idx1 may be
// nullptr) name the rows to recompute and the others are copied from agg_in.
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int sbt_mst(const void* cost, const void* masks, const void* idx0, const void* idx1,
                       const void* agg_in, void* out, int n_tasks, int K, int N, void* stream) {
  if (n_tasks <= 0 || K <= 0 || N <= 0 || N > kMaxVpl * kBlockWarps * kWarp)
    return (int)cudaErrorInvalidValue;
  const auto* c = static_cast<const float*>(cost);
  const auto* m = static_cast<const uint8_t*>(masks);
  const auto* i0 = static_cast<const int64_t*>(idx0);
  const auto* i1 = static_cast<const int64_t*>(idx1);
  const auto* a = static_cast<const float*>(agg_in);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (N <= kMaxVpl * kWarp)
    return (int)launch<1>(values_per_thread(N, kWarp), c, m, i0, i1, a, o, n_tasks, K, N, s);
  return (int)launch<kBlockWarps>(values_per_thread(N, kBlockWarps * kWarp), c, m, i0, i1, a,
                                  o, n_tasks, K, N, s);
}
