// gather_apply — the weighted plane gather of the B / B' gather tables.
//
//   out[r] = sum_{j=0}^{w-1} vals[j, r] * xhat[idx[j, r]],   xhat[n_src] = 0
//   then, for a row r that has overflow entries, its overflow planes
//   ov_vals[j, t] * xhat[ov_idx[j, t]], j = 0 .. wov-1, added in that order
//
// Replaces the TPU kernel permon_tpu/core/sell.py::_sell_gather_pallas
// (driven by SEllGather.__call__ and the table multiply of
// SubdomainExtension.mv/rmv, permon_tpu/core/extension.py:240-277).  The
// TPU kernel only moved raw 32-bit words through SELL rounds of in-register
// gathers; the value multiply and the plane sum ran outside it.  Hopper has
// a fast global gather, so this kernel reads the plane-major tables directly
// and fuses the multiply, the plane sum and the overflow.
//
// Bound: memory bytes (w table entries of 4 + 4 or 8 bytes per row, one
// output word, x once; 2 flops per entry are far below the line).  The
// design keeps wide loads in flight and makes an apply one launch:
//
// - a thread owns R neighbouring rows (2, or 4 when values and output are
//   f32) and reads each plane's indices and values as one 8- or 16-byte
//   load; the planes are padded on the host to a stride that is a multiple
//   of 4, so every plane starts aligned (a table whose stride or pointers
//   do not allow it runs with R = 1);
// - the loads of up to four planes' indices and values are started first,
//   then all their gathers of x, then the rounded multiplies and adds in
//   plane order: two round trips to memory per row instead of 2 w;
// - the overflow of B' (a few rows with more entries than the table's
//   width) is added by the thread that owns the row, in the same launch.
//   A marker built on the host holds, for each group of 256 rows, the
//   number of overflow rows before the group and 8 bitmasks of 32 rows:
//   row r finds its overflow column as that count + the set bits before
//   its own.  It costs 36 bytes per 256 rows, 0.6% of an f64 table of
//   width 2.  No second launch, no atomics.
//
// Measured on an H100 (PERF.md): the single launch takes the time of the
// replaced kernel's table launch plus ~1 us and saves its overflow launch
// (~8 us between two events); the wide loads alone move nothing, a table
// launch of either kernel runs at about its round trips plus its bytes at
// ~3 TB/s.
//
// Numerics: the planes are added in order (plane 0, plane 1, ..., then the
// overflow planes in entry order) with explicitly rounded multiplies and
// adds (__dmul_rn/__dadd_rn and the f32 forms), and the library is built
// with --fmad=false: no FMA contraction, so the result is bitwise equal to
// the plain PyTorch version in permon_tpu_torch/core/sell.py.  The sum
// starts from -0, the identity of the rounded add (-0 + p = p for every p,
// also for p = -0), which equals assigning the first product.  Pad entries
// (index n_src, value 0) are multiplied and added like any other, as the
// plain version does.  The output type is the promotion of the value and
// vector types; both operands are converted to it before the multiply, as
// the JAX table path does.
//
// permon_gather_apply_v1 is the kernel this one replaced (one row per
// thread, a plane at a time, the overflow as a second launch that adds onto
// out[tgt[r]]).  Only the timing helper reaches it, to time old against new
// on one card.

#include <cuda_runtime.h>
#include <stdint.h>

// What an apply needs of the table; the host keeps one per launch plan.
struct GatherArgs {
  const int32_t* idx;      // w planes of `stride` entries, nrows of them rows
  const void* vals;        // the same layout, of vals_dtype
  const int32_t* ov_mark;  // null for a table without overflow
  const int32_t* ov_idx;   // wov planes of nt entries
  const void* ov_vals;
  int32_t vals_dtype;  // 0 = float32, 1 = float64
  int32_t w, nrows, stride, n_src, wov, nt;
};

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
// the pad slot (i == n_src) reads 0; the host validates tables to [0, n_src],
// the unsigned compare also keeps any other index from reading outside x
__device__ __forceinline__ bool in_range(int i, int n) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(n);
}

// R neighbouring table entries moved by one load
template <typename T, int R>
struct alignas(sizeof(T) * R) Vec {
  T v[R];
};

constexpr int kPlanes = 4;  // planes whose loads are in flight together

// acc[k] += planes 0 .. w-1 of rows r0 .. r0+R-1, in plane order
template <typename V, typename X, typename O, int R>
__device__ __forceinline__ void add_planes(const int32_t* __restrict__ idx,
                                           const V* __restrict__ vals,
                                           const X* __restrict__ x, int w, size_t stride,
                                           size_t r0, int n_src, O (&acc)[R]) {
  for (int j0 = 0; j0 < w; j0 += kPlanes) {
    Vec<int32_t, R> ci[kPlanes];
    Vec<V, R> cv[kPlanes];
    O xv[kPlanes][R];
#pragma unroll
    for (int u = 0; u < kPlanes; ++u) {
      if (j0 + u < w) {
        const size_t t = static_cast<size_t>(j0 + u) * stride + r0;
        ci[u] = *reinterpret_cast<const Vec<int32_t, R>*>(idx + t);
        cv[u] = *reinterpret_cast<const Vec<V, R>*>(vals + t);
      }
    }
#pragma unroll
    for (int u = 0; u < kPlanes; ++u) {
      if (j0 + u < w) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int i = ci[u].v[k];
          xv[u][k] = in_range(i, n_src) ? static_cast<O>(x[i]) : static_cast<O>(0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kPlanes; ++u) {
      if (j0 + u < w) {
#pragma unroll
        for (int k = 0; k < R; ++k)
          acc[k] = add_rn(acc[k], mul_rn(static_cast<O>(cv[u].v[k]), xv[u][k]));
      }
    }
  }
}

template <typename V, typename X, typename O, int R>
__global__ void gather_apply_kernel(const int32_t* __restrict__ idx,
                                    const V* __restrict__ vals,
                                    const X* __restrict__ x, O* __restrict__ out,
                                    int w, int nrows, int stride, int n_src,
                                    const int32_t* __restrict__ ov_mark,
                                    const int32_t* __restrict__ ov_idx,
                                    const V* __restrict__ ov_vals, int wov, int nt) {
  const int r0 = (blockIdx.x * blockDim.x + threadIdx.x) * R;
  if (r0 >= nrows) return;
  // R divides 32, so the thread's rows share one mask word of the marker:
  // per group of 256 rows the overflow rows before the group, then 8 masks
  const int32_t* group = nullptr;
  const int word = (r0 >> 5) & 7;
  unsigned mask = 0u;
  if (ov_mark != nullptr) {
    group = ov_mark + static_cast<size_t>(r0 >> 8) * 9;
    mask = static_cast<unsigned>(group[1 + word]);
  }
  O acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = static_cast<O>(-0.0);
  add_planes<V, X, O, R>(idx, vals, x, w, stride, r0, n_src, acc);
  if (mask != 0u) {
    // overflow rows before this mask word: the group's count and the
    // group's earlier words (independent loads of one 36-byte record)
    unsigned before = static_cast<unsigned>(group[0]);
#pragma unroll
    for (int q = 0; q < 7; ++q)
      before += (q < word) ? __popc(static_cast<unsigned>(group[1 + q])) : 0;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const unsigned bit = static_cast<unsigned>(r0 + k) & 31u;
      if ((mask >> bit) & 1u) {
        const size_t t = before + __popc(mask & ((1u << bit) - 1u));
        O one[1] = {acc[k]};
        add_planes<V, X, O, 1>(ov_idx, ov_vals, x, wov, nt, t, n_src, one);
        acc[k] = one[0];
      }
    }
  }
  if (r0 + R <= nrows) {
    Vec<O, R> o;
#pragma unroll
    for (int k = 0; k < R; ++k) o.v[k] = acc[k];
    *reinterpret_cast<Vec<O, R>*>(out + r0) = o;
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (r0 + k < nrows) out[r0 + k] = acc[k];
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename V, typename X, typename O, int R>
int launch_rows(const GatherArgs& a, const void* x, void* out, cudaStream_t stream) {
  const int threads = 128;
  const int owners = (a.nrows + R - 1) / R;
  const int blocks = (owners + threads - 1) / threads;
  gather_apply_kernel<V, X, O, R><<<blocks, threads, 0, stream>>>(
      a.idx, static_cast<const V*>(a.vals), static_cast<const X*>(x),
      static_cast<O*>(out), a.w, a.nrows, a.stride, a.n_src, a.ov_mark, a.ov_idx,
      static_cast<const V*>(a.ov_vals), a.wov, a.nt);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename X, typename O>
int launch(const GatherArgs& a, const void* x, void* out, cudaStream_t stream) {
  // rows per thread: 16-byte loads of the wider of value and output
  constexpr int R = (sizeof(V) == 4 && sizeof(O) == 4) ? 4 : 2;
  const bool wide = a.stride % R == 0 && aligned(a.idx, 4 * R) &&
                    aligned(a.vals, sizeof(V) * R) && aligned(out, sizeof(O) * R);
  if (wide) return launch_rows<V, X, O, R>(a, x, out, stream);
  return launch_rows<V, X, O, 1>(a, x, out, stream);
}

// ------------------------------------------------- the kernel replaced (v1)

template <typename V, typename X, typename O>
__global__ void gather_apply_kernel_v1(const int32_t* __restrict__ idx,
                                       const V* __restrict__ vals,
                                       const X* __restrict__ x,
                                       O* __restrict__ out,
                                       const int32_t* __restrict__ tgt,
                                       int w, int nrows, int stride, int n_src) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrows) return;
  const int dst = (tgt != nullptr) ? tgt[r] : r;
  O acc;
  int j = 0;
  if (tgt != nullptr) {
    acc = out[dst];
  } else {
    const int i = idx[r];
    const O xv = in_range(i, n_src) ? static_cast<O>(x[i]) : static_cast<O>(0);
    acc = mul_rn(static_cast<O>(vals[r]), xv);
    j = 1;
  }
  for (; j < w; ++j) {
    const size_t t = static_cast<size_t>(j) * stride + r;
    const int i = idx[t];
    const O xv = in_range(i, n_src) ? static_cast<O>(x[i]) : static_cast<O>(0);
    acc = add_rn(acc, mul_rn(static_cast<O>(vals[t]), xv));
  }
  out[dst] = acc;
}

template <typename V, typename X, typename O>
int launch_v1(const void* idx, const void* vals, const void* x, void* out,
              const void* tgt, int w, int nrows, int stride, int n_src,
              cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (nrows + threads - 1) / threads;
  gather_apply_kernel_v1<V, X, O><<<blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const V*>(vals),
      static_cast<const X*>(x), static_cast<O*>(out),
      static_cast<const int32_t*>(tgt), w, nrows, stride, n_src);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype: 0 = float32, 1 = float64.  Output type = promotion of the value
// and vector types (float64 if either is float64).  Returns the
// cudaGetLastError() code of the launch (0 = success); -1 for a dtype pair
// it does not take.
extern "C" int permon_gather_apply(const GatherArgs* a, int x_dtype, const void* x,
                                   void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->vals_dtype == 0 && x_dtype == 0) return launch<float, float, float>(*a, x, out, s);
  if (a->vals_dtype == 1 && x_dtype == 1) return launch<double, double, double>(*a, x, out, s);
  if (a->vals_dtype == 1 && x_dtype == 0) return launch<double, float, double>(*a, x, out, s);
  if (a->vals_dtype == 0 && x_dtype == 1) return launch<float, double, double>(*a, x, out, s);
  return -1;
}

// The replaced kernel: with tgt (nrows unique targets) row r adds its planes
// onto out[tgt[r]], starting from the value already there.
extern "C" int permon_gather_apply_v1(int vals_dtype, int x_dtype, const void* idx,
                                      const void* vals, const void* x, void* out,
                                      const void* tgt, int w, int nrows, int stride,
                                      int n_src, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_dtype == 0 && x_dtype == 0)
    return launch_v1<float, float, float>(idx, vals, x, out, tgt, w, nrows, stride, n_src, s);
  if (vals_dtype == 1 && x_dtype == 1)
    return launch_v1<double, double, double>(idx, vals, x, out, tgt, w, nrows, stride, n_src, s);
  if (vals_dtype == 1 && x_dtype == 0)
    return launch_v1<double, float, double>(idx, vals, x, out, tgt, w, nrows, stride, n_src, s);
  if (vals_dtype == 0 && x_dtype == 1)
    return launch_v1<float, double, double>(idx, vals, x, out, tgt, w, nrows, stride, n_src, s);
  return -1;
}
