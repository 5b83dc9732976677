// gather_apply — the weighted plane gather of the B / B' gather tables.
//
//   out[r] = sum_{j=0}^{w-1} vals[j, r] * xhat[idx[j, r]],   xhat[n_src] = 0
//
// Replaces the TPU kernel permon_tpu/core/sell.py::_sell_gather_pallas
// (driven by SEllGather.__call__ and the table multiply of
// SubdomainExtension.mv/rmv, permon_tpu/core/extension.py:240-277).  The
// TPU kernel only moved raw 32-bit words through SELL rounds of in-register
// gathers; the value multiply and the plane sum ran outside it.  Hopper has
// a fast global gather, so this kernel reads the plane-major tables directly
// and fuses the multiply and the plane sum.
//
// Bound: memory.  Per output row it streams w table entries (4 B index +
// 4 or 8 B value each, ~12 B per plane for f64 values), one output word,
// and one gathered word of x per plane.  The design is a straight coalesced
// stream: one thread per output row, so thread r reads idx[j*nrows + r] and
// vals[j*nrows + r] for consecutive r in consecutive threads (plane-major
// layout); only the x reads are scattered.  cp.async/TMA staging and
// fusion with the K+ apply are later work.
//
// Numerics: the planes are added in order (plane 0, then plane 1, ...) with
// explicitly rounded multiplies and adds (__dmul_rn/__dadd_rn and the f32
// forms), and the library is also built with --fmad=false: no FMA
// contraction, so the result is bitwise equal to the plain PyTorch version
// in permon_tpu_torch/core/sell.py.  The output type is the promotion of the
// value and vector types; both operands are converted to it before the
// multiply, as the JAX table path does.
//
// Accumulate mode (tgt != nullptr): thread r adds its planes onto
// out[tgt[r]], starting from the value already there.  This is the overflow
// COO of B' (core/extension.py:266-268): the host sorts the overflow
// entries by target and packs each target's entries into planes in entry
// order, so every target is owned by one thread and the adds happen in the
// order of the sequential scatter — no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename V, typename X, typename O>
__global__ void gather_apply_kernel(const int32_t* __restrict__ idx,
                                    const V* __restrict__ vals,
                                    const X* __restrict__ x,
                                    O* __restrict__ out,
                                    const int32_t* __restrict__ tgt,
                                    int w, int nrows, int n_src) {
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
    const size_t t = static_cast<size_t>(j) * nrows + r;
    const int i = idx[t];
    const O xv = in_range(i, n_src) ? static_cast<O>(x[i]) : static_cast<O>(0);
    acc = add_rn(acc, mul_rn(static_cast<O>(vals[t]), xv));
  }
  out[dst] = acc;
}

template <typename V, typename X, typename O>
int launch(const void* idx, const void* vals, const void* x, void* out,
           const void* tgt, int w, int nrows, int n_src, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (nrows + threads - 1) / threads;
  gather_apply_kernel<V, X, O><<<blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const V*>(vals),
      static_cast<const X*>(x), static_cast<O*>(out),
      static_cast<const int32_t*>(tgt), w, nrows, n_src);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = float64.  Output type = promotion of the
// two (float64 if either is float64).  Returns the cudaGetLastError() code
// of the launch (0 = success); -1 for a dtype pair it does not take.
extern "C" int permon_gather_apply(int vals_dtype, int x_dtype,
                                   const void* idx, const void* vals,
                                   const void* x, void* out, const void* tgt,
                                   int w, int nrows, int n_src, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_dtype == 0 && x_dtype == 0)
    return launch<float, float, float>(idx, vals, x, out, tgt, w, nrows, n_src, s);
  if (vals_dtype == 1 && x_dtype == 1)
    return launch<double, double, double>(idx, vals, x, out, tgt, w, nrows, n_src, s);
  if (vals_dtype == 1 && x_dtype == 0)
    return launch<double, float, double>(idx, vals, x, out, tgt, w, nrows, n_src, s);
  if (vals_dtype == 0 && x_dtype == 1)
    return launch<float, double, double>(idx, vals, x, out, tgt, w, nrows, n_src, s);
  return -1;
}
