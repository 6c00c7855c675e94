// Categorical draws by inverse CDF: the one-hot row (bool) of each row of
// unnormalized probabilities p (rows, C) float32, given one uniform u (rows)
// float32 a row. Every source draw of the port on the card runs here.
//
// Replaces no TPU kernel: the JAX package draws its sources with jax.random
// inside XLA. It was added because the port's plain version
// (ops/draw.py::onehot_plain: torch.cumsum, then a multiply, a compare, a
// sum, a clamp and an equality) spends nearly all its time in PyTorch's scan
// of the innermost dimension, which runs one 512-thread block per row when
// there are many more rows than columns: ATen/native/cuda/ScanUtils.cuh,
// get_log_num_threads_x_inner_scan<uint32_t>, takes log2(C) - log2(rows) in
// unsigned arithmetic, the difference wraps and the clamp to [4, 9] gives 512
// threads in x, so each 3-wide row pays a block and a dozen barriers.
//
// Semantics, bit for bit the plain version's on the card:
//   1. cdf = the inclusive prefix sums of the row, in the association of
//      PyTorch's in-block Sklansky scan (tensor_kernel_scan_innermost_dim_impl):
//      at level m (s = 2^m) each column k with bit m set adds the column
//      (k & ~(s - 1)) - 1, the top of the lower half of its block of 2s. So
//      cdf[2] = (p0 + p1) + p2 and cdf[3] = (p0 + p1) + (p2 + p3). The levels
//      above log2(C) add only to columns >= C, so the block's width does not
//      matter. A tensor of one row is scanned by cub's DeviceScan instead,
//      15 items a thread (kCubItems): each run of 15 is folded left to right
//      from the sum of the runs before it, which for the second run is the
//      first run's total and for the third (C > 30) the first two totals
//      added. So a single row takes p0, p0 + p1, (p0 + p1) + p2, ... up to
//      C = 30. The sign of a zero, which the in-block scan's "+ 0" of the
//      first column may flip, reaches no comparison.
//   2. t = u * cdf[C - 1];
//   3. idx = min(#{k : t >= cdf[k]}, C - 1);
//   4. the one-hot row of idx.
// Every add and the multiply are rounded on their own (__fadd_rn, __fmul_rn):
// no contraction into an FMA. So an all-zero row yields the last category and
// a row with a NaN (its total NaN, t NaN, no comparison true) category 0.
//
// Bound on an H100: memory. A row reads 4C + 4 bytes and writes C: 19 bytes
// at C = 3, 1.7 ms for a Grambank initializer draw of 308M rows at 3.35 TB/s.
//
// Design: one thread a row, a grid-stride loop with 64-bit offsets (that
// draw has 924M elements). C is a template parameter (1 to 32), so the row's
// prefix sums stay in registers and every loop unrolls. A warp's loads of a
// column are strided by 4C bytes but touch the same few cache lines as its
// other columns, so the rows are read once from memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxComponents = 32;       // ops/draw.py: MAX_COMPONENTS
constexpr int kCubItems = 15;            // items a thread of cub's scan of one row

template <int C>
__global__ void __launch_bounds__(kThreads)
draw_kernel(const float* __restrict__ p, const float* __restrict__ u, uint8_t* __restrict__ out,
            int64_t n_rows) {
  const bool one_row = n_rows == 1;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += stride) {
    const float* pr = p + row * C;
    float cdf[C];
#pragma unroll
    for (int k = 0; k < C; ++k) cdf[k] = __ldg(pr + k);
    if (one_row) {
      float before = 0.0f;                 // the totals of the runs before, added
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += kCubItems) {
        const int k1 = k0 + kCubItems < C ? k0 + kCubItems : C;
        float total = cdf[k0];
#pragma unroll
        for (int k = k0 + 1; k < k1; ++k) total = __fadd_rn(total, cdf[k]);
        if (k0 > 0) cdf[k0] = __fadd_rn(before, cdf[k0]);
#pragma unroll
        for (int k = k0 + 1; k < k1; ++k) cdf[k] = __fadd_rn(cdf[k - 1], cdf[k]);
        before = k0 > 0 ? __fadd_rn(before, total) : total;
      }
    } else {
#pragma unroll
      for (int s = 1; s < C; s <<= 1) {
#pragma unroll
        for (int k = 0; k < C; ++k)
          if (k & s) cdf[k] = __fadd_rn(cdf[k], cdf[(k & ~(s - 1)) - 1]);
      }
    }
    const float t = __fmul_rn(__ldg(u + row), cdf[C - 1]);
    int idx = 0;
#pragma unroll
    for (int k = 0; k < C; ++k) idx += t >= cdf[k];
    idx = min(idx, C - 1);
    uint8_t* o = out + row * C;
#pragma unroll
    for (int k = 0; k < C; ++k) o[k] = k == idx;
  }
}

}  // namespace

// p (n_rows, C) and u (n_rows,) float32, out (n_rows, C) bool, all contiguous;
// 1 <= C <= kMaxComponents; `blocks` caps the grid (the grid-stride loop
// takes the rest). Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int sbt_draw(const void* p, const void* u, void* out, int64_t n_rows, int C,
                        int blocks, void* stream) {
  if (n_rows <= 0 || blocks <= 0 || C < 1 || C > kMaxComponents)
    return (int)cudaErrorInvalidValue;
  const int64_t need = (n_rows + kThreads - 1) / kThreads;
  const int grid = (int)(need < blocks ? need : blocks);
  const auto* pp = static_cast<const float*>(p);
  const auto* uu = static_cast<const float*>(u);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
#define SBT_DRAW_CASE(N) \
  case N:                \
    draw_kernel<N><<<grid, kThreads, 0, s>>>(pp, uu, o, n_rows); \
    break;
    SBT_DRAW_CASE(1) SBT_DRAW_CASE(2) SBT_DRAW_CASE(3) SBT_DRAW_CASE(4)
    SBT_DRAW_CASE(5) SBT_DRAW_CASE(6) SBT_DRAW_CASE(7) SBT_DRAW_CASE(8)
    SBT_DRAW_CASE(9) SBT_DRAW_CASE(10) SBT_DRAW_CASE(11) SBT_DRAW_CASE(12)
    SBT_DRAW_CASE(13) SBT_DRAW_CASE(14) SBT_DRAW_CASE(15) SBT_DRAW_CASE(16)
    SBT_DRAW_CASE(17) SBT_DRAW_CASE(18) SBT_DRAW_CASE(19) SBT_DRAW_CASE(20)
    SBT_DRAW_CASE(21) SBT_DRAW_CASE(22) SBT_DRAW_CASE(23) SBT_DRAW_CASE(24)
    SBT_DRAW_CASE(25) SBT_DRAW_CASE(26) SBT_DRAW_CASE(27) SBT_DRAW_CASE(28)
    SBT_DRAW_CASE(29) SBT_DRAW_CASE(30) SBT_DRAW_CASE(31) SBT_DRAW_CASE(32)
#undef SBT_DRAW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
