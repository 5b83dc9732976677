// det_sum — the fixed-tree reduction of permon_tpu_torch/core/detred.py on
// the card, with an optional second factor multiplied in:
//
//     out[r] = tree_i (a[r, i] * b[r, i])      (or tree_i a[r, i] without b)
//
// where tree is the pairing of det_sum: at a level of n values, value i is
// added to value i + n/2 (i < n/2) and, for odd n, the last value is carried
// to position n/2; the next level has ceil(n/2) values, down to one.
//
// It replaces no Pallas kernel.  The JAX package's det_sum
// (permon_tpu/core/detred.py:64) is a Python loop of adds that XLA fuses
// into one program; PyTorch runs the same loop op by op, one add (and a cat
// at an odd level) a launch, after a product written to memory.  In the
// large path's dual CG that is ~130 launches a turn (CG's dots, BlockCoarse
// G v over 13,440 dofs a subdomain, the explicit coarse inverse).
//
// Bound: the bytes of a and b read once (2 flops an element are far below
// the line).  The design keeps the product and every level but the last few
// in registers:
//
// - Thread j of a row computes value j of level L directly from the input:
//   its sub-tree has 2^L leaves at j + sum of a subset of the level offsets
//   h_0 .. h_{L-1} (h_d = n_d / 2), added in the tree's order.  The leaves'
//   loads are independent, so they are in flight together; neighbouring
//   threads read neighbouring elements of each leaf.  Only the last value of
//   a level can hold a carried value (the carry sits at the end of its level
//   and its ancestors are the ends of theirs), so every thread but the last
//   one of a row evaluates a full binary sub-tree; the last one walks the
//   chain of ends, with a full sub-tree on the left of each node that is not
//   carried.
// - A final pass runs one block per group of rows, and finishes the levels
//   below L in shared memory (two buffers, one barrier a level).  A partial
//   pass writes level L to a scratch array (rows, n_L) instead, spread over
//   as many blocks as it needs; the host then launches a final pass on it.
//   The host picks the passes from the shape alone (core/detred.py
//   tree_passes): the pass over the inputs evaluates at most 4 levels a
//   thread, so that an SM holds many threads, each with its 16 leaves' loads
//   in flight (measured on an H100: 2.7 TB/s streaming one long row at 2-5
//   levels, 1.9 TB/s at 7).  Rows that then fit a block take one launch;
//   longer ones (BlockCoarse's 13,440 dofs, CG's dots) a partial pass and a
//   final pass over the scratch, which L2 holds.  No atomics, no order that
//   depends on timing.
// - Rows whose layout is contiguous across rows and strided along the sum
//   (a matrix reduced along axis 0, BlockCoarse's (ns, nlp, 6) bases reduced
//   over the dofs) are taken G at a time by one block, G rows on neighbouring
//   threads, so that a warp still reads neighbouring addresses.
//
// Numerics: products by __fmul_rn / __dmul_rn, sums by __fadd_rn / __dadd_rn
// (the library is also built with --fmad=false), so nothing contracts into an
// FMA and the result is bitwise the plain tree (det_sum_plain) on the card or
// on the CPU, for the same inputs.
//
// Rows come from up to kMaxParts base pointers (det_dots: one vector pair a
// part), and inside a part from up to kRowDims dimensions with their own
// strides for a and b (a stride 0 broadcasts).  All sizes and strides are in
// elements.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxParts = 8;
constexpr int kRowDims = 4;
constexpr int kMaxLevels = 7;
constexpr int kMaxThreads = 1024;

// One launch: the host keeps one per pass of a layout and sets the pointers
// before each launch.
struct DetSumArgs {
  const void* a[kMaxParts];   // first factor of each part (a pass's source)
  const void* b[kMaxParts];   // second factor of each part, or null (has_b 0)
  void* out;                  // (rows,) final; (rows, n_L) partial
  int64_t n;                  // elements a row at the source
  int64_t sa;                 // stride of a along the sum
  int64_t sb;                 // stride of b along the sum
  int64_t size[kRowDims];     // row dimensions inside a part, outermost first
  int64_t sta[kRowDims];      // their strides in a
  int64_t stb[kRowDims];      // their strides in b
  int64_t rows_per_part;      // the product of size
  int64_t rows;               // parts x rows_per_part
  int32_t dtype;              // 0 = float32, 1 = float64 (a, b and out)
  int32_t has_b;
  int32_t levels;             // L: levels a thread evaluates in registers
  int32_t group;              // G: neighbouring rows a block
  int32_t span;               // J: values of level L a block, per row
  int32_t partial;            // 1: write level L; 0: finish the tree
};

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T, bool HB>
__device__ __forceinline__ T leaf(const T* a, const T* b) {
  if constexpr (HB) {
    return mul_rn(__ldg(a), __ldg(b));
  } else {
    return __ldg(a);
  }
}

// A node D levels above the source, its leaves at a (and b) plus subset sums
// of ha[0..D-1] (hb[...]): the offsets h_d times the strides along the sum.
template <typename T, bool HB, int D>
struct Tree {
  // none of the sub-tree is carried: 2^D leaves, added in the tree's order
  static __device__ __forceinline__ T full(const T* a, const T* b, const int64_t* ha,
                                           const int64_t* hb) {
    const T left = Tree<T, HB, D - 1>::full(a, b, ha, hb);
    const T right = Tree<T, HB, D - 1>::full(a + ha[D - 1], HB ? b + hb[D - 1] : b, ha, hb);
    return add_rn(left, right);
  }
  // the last value of its level: carried from its right child where the
  // level below is odd (bit D-1 of odd), else left (full) + right (last)
  static __device__ __forceinline__ T last(const T* a, const T* b, const int64_t* ha,
                                           const int64_t* hb, unsigned odd) {
    const T right =
        Tree<T, HB, D - 1>::last(a + ha[D - 1], HB ? b + hb[D - 1] : b, ha, hb, odd);
    if ((odd >> (D - 1)) & 1u) return right;
    return add_rn(Tree<T, HB, D - 1>::full(a, b, ha, hb), right);
  }
};

template <typename T, bool HB>
struct Tree<T, HB, 0> {
  static __device__ __forceinline__ T full(const T* a, const T* b, const int64_t*,
                                           const int64_t*) {
    return leaf<T, HB>(a, b);
  }
  static __device__ __forceinline__ T last(const T* a, const T* b, const int64_t*,
                                           const int64_t*, unsigned) {
    return leaf<T, HB>(a, b);
  }
};

template <typename T, bool HB, int L>
__global__ void __launch_bounds__(kMaxThreads) det_sum_kernel(const DetSumArgs args) {
  const int G = args.group, J = args.span;
  const int tid = threadIdx.x;
  const int g = tid % G, jl = tid / G;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * G + g;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * J + jl;

  // level sizes: h[d] = n_d / 2, n_{d+1} = n_d - h[d]; m ends as n_L
  int64_t ha[L > 0 ? L : 1], hb[L > 0 ? L : 1];
  unsigned odd = 0;
  int64_t m = args.n;
#pragma unroll
  for (int d = 0; d < L; ++d) {
    const int64_t h = m >> 1;
    odd |= static_cast<unsigned>(m & 1) << d;
    ha[d] = h * args.sa;
    hb[d] = h * args.sb;
    m -= h;
  }

  T v = T(0);
  const bool live = row < args.rows && j < m;
  if (live) {
    // the row's offsets: 32-bit divisions (the host keeps rows below 2^31)
    unsigned rem = static_cast<unsigned>(row), part = 0;
    if (args.rows != args.rows_per_part) {
      part = rem / static_cast<unsigned>(args.rows_per_part);
      rem -= part * static_cast<unsigned>(args.rows_per_part);
    }
    int64_t oa = j * args.sa, ob = j * args.sb;
#pragma unroll
    for (int d = kRowDims - 1; d >= 0; --d) {
      if (args.size[d] != 1) {
        const unsigned size = static_cast<unsigned>(args.size[d]);
        const unsigned q = rem / size;
        const int64_t i = rem - q * size;
        rem = q;
        oa += i * args.sta[d];
        ob += i * args.stb[d];
      }
    }
    const void* pa = args.a[0];
    const void* pb = args.b[0];
#pragma unroll
    for (int k = 1; k < kMaxParts; ++k) {
      if (part == static_cast<unsigned>(k)) {
        pa = args.a[k];
        pb = args.b[k];
      }
    }
    const T* a = static_cast<const T*>(pa) + oa;
    const T* b = HB ? static_cast<const T*>(pb) + ob : a;
    v = (j + 1 < m) ? Tree<T, HB, L>::full(a, b, ha, hb)
                    : Tree<T, HB, L>::last(a, b, ha, hb, odd);
  }
  if (args.partial) {  // uniform over the grid
    if (live) static_cast<T*>(args.out)[row * m + j] = v;
    return;
  }

  // finish in shared memory: level values of the G rows, position-major
  extern __shared__ __align__(16) unsigned char smem[];
  T* src = reinterpret_cast<T*>(smem);
  T* dst = src + G * J;
  src[tid] = v;
  __syncthreads();
  while (m > 1) {
    const int64_t h = m >> 1, m1 = m - h;
    if (jl < m1) dst[tid] = (jl < h) ? add_rn(src[tid], src[tid + h * G]) : src[tid + h * G];
    T* t = src;
    src = dst;
    dst = t;
    m = m1;
    __syncthreads();
  }
  if (jl == 0 && row < args.rows) static_cast<T*>(args.out)[row] = src[g];
}

template <typename T, bool HB, int L>
int launch(const DetSumArgs& a, cudaStream_t stream) {
  int64_t m = a.n;
  for (int d = 0; d < L; ++d) m -= m >> 1;
  const int64_t groups = (a.rows + a.group - 1) / a.group;
  const int64_t chunks = a.partial ? (m + a.span - 1) / a.span : 1;
  if (groups > 0x7fffffff || chunks > 65535 || (!a.partial && m > a.span)) return -2;
  const int threads = a.group * a.span;
  const size_t smem = a.partial ? 0 : 2 * sizeof(T) * static_cast<size_t>(threads);
  det_sum_kernel<T, HB, L><<<dim3(static_cast<unsigned>(groups), static_cast<unsigned>(chunks)),
                             threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool HB>
int by_levels(const DetSumArgs& a, cudaStream_t s) {
  switch (a.levels) {
    case 0: return launch<T, HB, 0>(a, s);
    case 1: return launch<T, HB, 1>(a, s);
    case 2: return launch<T, HB, 2>(a, s);
    case 3: return launch<T, HB, 3>(a, s);
    case 4: return launch<T, HB, 4>(a, s);
    case 5: return launch<T, HB, 5>(a, s);
    case 6: return launch<T, HB, 6>(a, s);
    case 7: return launch<T, HB, 7>(a, s);
  }
  return -2;
}

}  // namespace

// Returns the cudaGetLastError() code of the launch (0 = success), -1 for a
// dtype it does not take, -2 for a pass it cannot run (the host's plan is
// checked against these limits).
extern "C" int permon_det_sum(const DetSumArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->n < 1 || a->rows < 1 || a->rows > 0x7fffffff || a->group < 1 || a->span < 1 ||
      a->group * a->span > kMaxThreads || a->levels < 0 || a->levels > kMaxLevels ||
      a->rows_per_part < 1 || a->rows > a->rows_per_part * kMaxParts)
    return -2;
  if (a->dtype == 0) return a->has_b ? by_levels<float, true>(*a, s) : by_levels<float, false>(*a, s);
  if (a->dtype == 1)
    return a->has_b ? by_levels<double, true>(*a, s) : by_levels<double, false>(*a, s);
  return -1;
}
