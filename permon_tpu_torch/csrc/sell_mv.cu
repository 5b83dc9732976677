// sell_mv — sparse matrix-vector product y = A x for any sparsity pattern.
//
// Replaces the TPU kernel permon_tpu/core/sell.py::_sell_mv_pallas (driven
// by SEll.mv, permon_tpu/core/sell.py:258-269).  The TPU kernel exists
// because that chip has no fast global gather: it schedules the nonzeros
// into rounds of (8, 128) in-register gathers over aligned windows of x.
// Hopper gathers from global memory through L2 at full speed, so nothing of
// the round plan is carried over; this kernel computes the same function,
// y = A x, on a format chosen for this card.
//
// Format: SELL-32-1 (sliced ELLPACK, slice height = one warp, no row
// sorting), built on the host from CSR with sorted columns.  Slice s holds
// rows 32 s .. 32 s + 31, padded to the longest row OF THAT SLICE and stored
// column-major inside the slice: the j-th nonzero of row 32 s + l sits at
// slice_ptr[s] + 32 j + l.  So the storage follows nnz for any pattern (one
// dense row costs 32 times its own length, not the whole matrix), and a
// warp reads idx and vals as full 128 B / 256 B lines.  Pad slots hold
// column 0 and value 0.
//
// Bound: memory bytes (every stored index, 4 B, and value, 4 or 8 B, the
// row lengths, x and y once; 2 flops per nonzero are far below the line).
// A row of ~5 nonzeros walked one nonzero at a time is a chain of a dozen
// dependent reads (row length, slice offset, then index -> x for each
// nonzero) with one small load in flight per thread.  The design keeps as
// many loads in flight as the row has:
//
// - one thread per row, one warp per slice, and ONE loop bound per warp:
//   the slice's width (slice_ptr[s + 1] - slice_ptr[s]) / 32, read together
//   with the row length;
// - the slice is walked in chunks of 8 planes: the 8 index loads and the 8
//   value loads are started first (independent, full lines), then the 8
//   gathers of x, then the 8 rounded multiplies and adds in column order.
//   A row of 5 nonzeros takes three round trips to memory instead of twelve.
//   No load sits under a branch: a plane past the slice's width reads the
//   slice's last plane again, a pad slot gathers its column 0;
// - every add is selected by j < row_len[r], so a pad slot is never added
//   (a pad's +0 could turn a -0 sum into +0).
//
// Measured on an H100 (PERF.md) this is 1-2% ahead of the replaced kernel
// in f64 and up to 6.5% in f32: with 64 resident warps an SM the replaced
// kernel was not held back by its chain of reads; a product of 21 MB takes
// about 2 us of round trips plus its bytes at ~3 TB/s with either.  A
// variant that staged the slices through shared memory with cp.async
// (persistent grid, ring of 2 or 3 stages) was slower at every shape timed
// and is not kept.
//
// Numerics: the products of a row are added in ascending column order with
// explicitly rounded multiplies and adds (__dmul_rn/__dadd_rn and the f32
// forms; the library is also built with --fmad=false), so the result is
// bitwise equal to the plain PyTorch version in
// permon_tpu_torch/core/sell.py (sell_mv_plain), which adds the same
// products plane by plane.  The sum starts from -0, the identity of the
// rounded add (-0 + p = p for every p), which equals assigning the first
// product; a row without nonzeros writes +0.  Values are converted to the
// type of x in registers and the output has the type of x, as the JAX
// operator computes V.astype(x.dtype) * G.
//
// permon_sell_mv_v1 is the kernel this one replaced (each thread loops to
// its own row length, one dependent index -> x pair at a time).  Only the
// timing helper reaches it, to time old against new on one card.

#include <cuda_runtime.h>
#include <stdint.h>

// What a product needs of the operator; the host keeps one per launch plan.
struct SellArgs {
  const int32_t* slice_ptr;  // (nslices + 1,)
  const int32_t* row_len;    // (nrows,)
  const int32_t* cols;       // (nslots,)
  const void* vals;          // (nslots,) of vals_dtype
  int32_t vals_dtype;        // 0 = float32, 1 = float64
  int32_t nrows;
};

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

constexpr int kSlice = 32;  // rows per slice = lanes of a warp

// The sum of one row: its slots are c[32 j], v[32 j] for j < width (the
// slice's width, the same for the whole warp), of which the first len are
// nonzeros.  U planes are loaded, gathered and added at a time.
template <typename V, typename X, int U>
__device__ __forceinline__ X row_sum(const int32_t* __restrict__ c,
                                     const V* __restrict__ v, int width, int len,
                                     const X* __restrict__ x) {
  X acc = static_cast<X>(-0.0);
  for (int j0 = 0; j0 < width; j0 += U) {
    int32_t ci[U];
    V vi[U];
    X xi[U];
    // no load sits under a branch, so the compiler starts them together: a
    // plane past the slice's width reads the last plane again (a hit), a
    // pad slot gathers its column 0
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = min(j0 + u, width - 1) * kSlice;
      ci[u] = c[t];
      vi[u] = v[t];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) xi[u] = x[ci[u]];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const X sum = add_rn(acc, mul_rn(static_cast<X>(vi[u]), xi[u]));
      acc = (j0 + u < len) ? sum : acc;
    }
  }
  return acc;
}

template <typename V, typename X, int U>
__global__ void sell_mv_kernel(const int32_t* __restrict__ slice_ptr,
                               const int32_t* __restrict__ row_len,
                               const int32_t* __restrict__ cols,
                               const V* __restrict__ vals,
                               const X* __restrict__ x,
                               X* __restrict__ y, int nrows) {
  // blockDim is a multiple of 32: the 32 rows of a slice are one warp
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = r / kSlice;
  if (s * kSlice >= nrows) return;  // the whole warp
  const int p0 = slice_ptr[s], p1 = slice_ptr[s + 1];
  const int len = (r < nrows) ? row_len[r] : 0;
  const int lane = r % kSlice;
  const X acc = row_sum<V, X, U>(cols + p0 + lane, vals + p0 + lane,
                                 (p1 - p0) / kSlice, len, x);
  if (r < nrows) y[r] = (len > 0) ? acc : static_cast<X>(0);
}

constexpr int kPlanes = 8;  // planes whose loads are in flight together

template <typename V, typename X>
int launch(const SellArgs& a, const void* x, void* y, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (a.nrows + threads - 1) / threads;
  sell_mv_kernel<V, X, kPlanes><<<blocks, threads, 0, stream>>>(
      a.slice_ptr, a.row_len, a.cols, static_cast<const V*>(a.vals),
      static_cast<const X*>(x), static_cast<X*>(y), a.nrows);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- the kernel replaced (v1)

template <typename V, typename X>
__global__ void sell_mv_kernel_v1(const int32_t* __restrict__ slice_ptr,
                                  const int32_t* __restrict__ row_len,
                                  const int32_t* __restrict__ cols,
                                  const V* __restrict__ vals,
                                  const X* __restrict__ x,
                                  X* __restrict__ y, int nrows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrows) return;
  const int len = row_len[r];
  const int base = slice_ptr[r / kSlice] + (r % kSlice);
  X acc = static_cast<X>(0);
  if (len > 0) {
    acc = mul_rn(static_cast<X>(vals[base]), x[cols[base]]);
    for (int j = 1; j < len; ++j) {
      const int t = base + j * kSlice;
      acc = add_rn(acc, mul_rn(static_cast<X>(vals[t]), x[cols[t]]));
    }
  }
  y[r] = acc;
}

template <typename V, typename X>
int launch_v1(const void* slice_ptr, const void* row_len, const void* cols,
              const void* vals, const void* x, void* y, int nrows,
              cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (nrows + threads - 1) / threads;
  sell_mv_kernel_v1<V, X><<<blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(slice_ptr), static_cast<const int32_t*>(row_len),
      static_cast<const int32_t*>(cols), static_cast<const V*>(vals),
      static_cast<const X*>(x), static_cast<X*>(y), nrows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype: 0 = float32, 1 = float64; the output has the type of x.  Returns
// the cudaGetLastError() code of the launch (0 = success); -1 for a dtype
// pair it does not take.  The host validates cols to [0, len(x)).
extern "C" int permon_sell_mv(const SellArgs* a, int x_dtype, const void* x, void* y,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->vals_dtype == 0 && x_dtype == 0) return launch<float, float>(*a, x, y, s);
  if (a->vals_dtype == 1 && x_dtype == 1) return launch<double, double>(*a, x, y, s);
  if (a->vals_dtype == 0 && x_dtype == 1) return launch<float, double>(*a, x, y, s);
  if (a->vals_dtype == 1 && x_dtype == 0) return launch<double, float>(*a, x, y, s);
  return -1;
}

extern "C" int permon_sell_mv_v1(int vals_dtype, int x_dtype, const void* slice_ptr,
                                 const void* row_len, const void* cols,
                                 const void* vals, const void* x, void* y,
                                 int nrows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_dtype == 0 && x_dtype == 0)
    return launch_v1<float, float>(slice_ptr, row_len, cols, vals, x, y, nrows, s);
  if (vals_dtype == 1 && x_dtype == 1)
    return launch_v1<double, double>(slice_ptr, row_len, cols, vals, x, y, nrows, s);
  if (vals_dtype == 0 && x_dtype == 1)
    return launch_v1<float, double>(slice_ptr, row_len, cols, vals, x, y, nrows, s);
  if (vals_dtype == 1 && x_dtype == 0)
    return launch_v1<double, float>(slice_ptr, row_len, cols, vals, x, y, nrows, s);
  return -1;
}
