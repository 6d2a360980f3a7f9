// The fused CG update: the per-iteration vector algebra of batched CG
// (core/solver.py, cg_batched) in three launches, each with a small
// deterministic second stage where it reduces.
//
// Replaces no TPU kernel: the reference leaves this algebra to XLA, which
// fuses it.  PyTorch runs it as eager ATen ops, each a pass over the block
// of nrhs columns: a product written then summed for <p, ap> and |r1|^2,
// a scaled copy then a sum for each axpy, two reads and a write for each
// of the guard's freeze-selects, 32 passes an iteration.  The same
// mathematics needs 11:
//   reduce, mode 0 (pap):  sum p * ap                    reads p, ap
//   reduce, mode 1 (rr1):  sum r1^2, r1 = -alpha ap + r  reads r, ap
//   apply:  x = alpha p + x;  r = -alpha ap + r;  p = beta p + r
//           in place, only in columns where accept      reads x, p, r, ap
//                                                        writes x, r, p
// The per-column scalars (alpha, beta, accept) stay on the device: the
// host reads nothing here.
//
// Bound on an H100: memory, about 1 flop a byte.  What the design does
// about it: every vector is read as (nrhs, L) contiguous rows, 16 bytes a
// thread where the rows allow it; a block takes a fixed run of one row
// (kThreads x kIters vectors), so the grid has many blocks for any nrhs
// and leaves no SM idle but the last wave's; a column the guard freezes is
// neither read nor written by apply.
//
// Roundings: each element is the plain version's two-op axpy,
// __fmul_rn then __fadd_rn (never contracted to an FMA), so given the same
// alpha, beta and accept, x, r and p are bit-equal to it; the r1 of mode 1
// is the r1 apply writes.  The reductions take each product in double and
// sum in double: short runs a thread, a warp-shuffle tree, a block tree,
// then one block a column sums the blocks' partials in a fixed order and
// rounds once to the vector's type.  No atomics, so the same inputs give
// the same bits on every run.
#include "wilson_plane.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kIters = 8;                    // vectors a thread, a block
constexpr int kRun = kThreads * kIters;      // vectors a block

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// W elements of T, loaded and stored as one access (16 bytes at W > 1).
template <typename T, int W>
struct alignas(sizeof(T) * W) Pack {
  T v[W];
};

template <typename T, int W>
__device__ __forceinline__ Pack<T, W> load(const T* base, int64_t i) {
  return reinterpret_cast<const Pack<T, W>*>(base)[i];
}

template <typename T, int W>
__device__ __forceinline__ void store(T* base, int64_t i,
                                      const Pack<T, W>& v) {
  reinterpret_cast<Pack<T, W>*>(base)[i] = v;
}

// The block's sum of every thread's v, in thread 0 (a fixed tree).
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// Block (chunk, column): partials[column * chunks + chunk] = the chunk's
// sum of a * b (RR1 false), or of r1^2 with r1 = -alpha[column] b + a.
template <typename T, int W, bool RR1>
__global__ void __launch_bounds__(kThreads)
    cg_reduce_kernel(const T* a, const T* b, const T* alpha, int64_t nvec,
                     double* partials) {
  const int col = blockIdx.y;
  const int64_t row = static_cast<int64_t>(col) * nvec;
  const T* ac = a + row * W;
  const T* bc = b + row * W;
  T na = T(0);
  if constexpr (RR1) na = -alpha[col];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRun + threadIdx.x;
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int64_t i = first + k * kThreads;
    if (i < nvec) {
      const Pack<T, W> va = load<T, W>(ac, i), vb = load<T, W>(bc, i);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if constexpr (RR1) {
          const double r1 = add_rn(mul_rn(na, vb.v[j]), va.v[j]);
          acc += r1 * r1;
        } else {
          acc += static_cast<double>(va.v[j]) * static_cast<double>(vb.v[j]);
        }
      }
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0)
    partials[static_cast<int64_t>(col) * gridDim.x + blockIdx.x] = acc;
}

// Block column: out[column] = the column's partials summed in a fixed
// order, rounded once to T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_sum_kernel(const double* partials, int chunks, T* out) {
  const double* pc = partials + static_cast<int64_t>(blockIdx.x) * chunks;
  double acc = 0.0;
  for (int i = threadIdx.x; i < chunks; i += kThreads) acc += pc[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<T>(acc);
}

// Block (chunk, column), where accept[column] (every column without
// accept): x = alpha p + x, r = -alpha ap + r, p = beta p + r, in place.
// An element is read whole before it is written, so x, r, p and ap may
// alias.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    cg_apply_kernel(T* x, T* r, T* p, const T* ap, const T* alpha,
                    const T* beta, const uint8_t* accept, int64_t nvec) {
  const int col = blockIdx.y;
  if (accept != nullptr && !accept[col]) return;
  const int64_t off = static_cast<int64_t>(col) * nvec * W;
  T* xc = x + off;
  T* rc = r + off;
  T* pc = p + off;
  const T* apc = ap + off;
  const T a = alpha[col], na = -a, bt = beta[col];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRun + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int64_t i = first + k * kThreads;
    if (i < nvec) {
      Pack<T, W> vx = load<T, W>(xc, i), vr = load<T, W>(rc, i);
      Pack<T, W> vp = load<T, W>(pc, i);
      const Pack<T, W> vap = load<T, W>(apc, i);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const T p0 = vp.v[j];
        vx.v[j] = add_rn(mul_rn(a, p0), vx.v[j]);
        vr.v[j] = add_rn(mul_rn(na, vap.v[j]), vr.v[j]);
        vp.v[j] = add_rn(mul_rn(bt, p0), vr.v[j]);
      }
      store<T, W>(xc, i, vx);
      store<T, W>(rc, i, vr);
      store<T, W>(pc, i, vp);
    }
  }
}

int64_t chunks_of(int64_t nvec) { return (nvec + kRun - 1) / kRun; }

bool bad_shape(int nrhs, int64_t len, int vec, int itemsize) {
  return nrhs < 1 || nrhs > 65535 || len < 1 ||
         (itemsize != 4 && itemsize != 8) ||
         (vec != 1 && vec * itemsize != 16) || len % vec != 0 ||
         chunks_of(len / vec) > 0x7fffffff;
}

template <typename T, int W>
cudaError_t reduce(const void* a, const void* b, const void* alpha,
                   double* partials, void* out, int nrhs, int64_t nvec,
                   int mode, cudaStream_t stream) {
  const int chunks = static_cast<int>(chunks_of(nvec));
  const dim3 grid(chunks, nrhs);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  const T* tal = static_cast<const T*>(alpha);
  if (mode == 0)
    cg_reduce_kernel<T, W, false>
        <<<grid, kThreads, 0, stream>>>(ta, tb, tal, nvec, partials);
  else
    cg_reduce_kernel<T, W, true>
        <<<grid, kThreads, 0, stream>>>(ta, tb, tal, nvec, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cg_sum_kernel<T><<<nrhs, kThreads, 0, stream>>>(partials, chunks,
                                                   static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t apply(void* x, void* r, void* p, const void* ap,
                  const void* alpha, const void* beta, const void* accept,
                  int nrhs, int64_t nvec, cudaStream_t stream) {
  const dim3 grid(static_cast<int>(chunks_of(nvec)), nrhs);
  cg_apply_kernel<T, W><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(x), static_cast<T*>(r), static_cast<T*>(p),
      static_cast<const T*>(ap), static_cast<const T*>(alpha),
      static_cast<const T*>(beta), static_cast<const uint8_t*>(accept),
      nvec);
  return cudaGetLastError();
}

}  // namespace

// The reduction of mode 0 (pap: <a, b> per column) or 1 (rr1: |r1|^2 per
// column, r1 = -alpha b + a) over nrhs rows of len elements of itemsize
// bytes (4 or 8), vec elements an access (1, or 16 / itemsize where every
// row starts 16-byte aligned); partials holds nrhs * cg_update_chunks(len
// / vec) doubles; out gets nrhs values of the vectors' type.
extern "C" int cg_update_reduce_launch(const void* a, const void* b,
                                       const void* alpha, void* partials,
                                       void* out, int nrhs, int64_t len,
                                       int vec, int itemsize, int mode,
                                       int device, void* stream) {
  wilson::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (bad_shape(nrhs, len, vec, itemsize) || (mode != 0 && mode != 1))
    return cudaErrorInvalidValue;
  double* part = static_cast<double*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nvec = len / vec;
  cudaError_t err;
  if (itemsize == 4)
    err = vec == 4 ? reduce<float, 4>(a, b, alpha, part, out, nrhs, nvec,
                                      mode, s)
                   : reduce<float, 1>(a, b, alpha, part, out, nrhs, nvec,
                                      mode, s);
  else
    err = vec == 2 ? reduce<double, 2>(a, b, alpha, part, out, nrhs, nvec,
                                       mode, s)
                   : reduce<double, 1>(a, b, alpha, part, out, nrhs, nvec,
                                       mode, s);
  return static_cast<int>(err);
}

// The update, in place: accept (nrhs bytes, 0 or 1) may be null, which
// writes every column.  Shapes as cg_update_reduce_launch.
extern "C" int cg_update_apply_launch(void* x, void* r, void* p,
                                      const void* ap, const void* alpha,
                                      const void* beta, const void* accept,
                                      int nrhs, int64_t len, int vec,
                                      int itemsize, int device, void* stream) {
  wilson::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (bad_shape(nrhs, len, vec, itemsize)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nvec = len / vec;
  cudaError_t err;
  if (itemsize == 4)
    err = vec == 4 ? apply<float, 4>(x, r, p, ap, alpha, beta, accept, nrhs,
                                     nvec, s)
                   : apply<float, 1>(x, r, p, ap, alpha, beta, accept, nrhs,
                                     nvec, s);
  else
    err = vec == 2 ? apply<double, 2>(x, r, p, ap, alpha, beta, accept, nrhs,
                                      nvec, s)
                   : apply<double, 1>(x, r, p, ap, alpha, beta, accept, nrhs,
                                      nvec, s);
  return static_cast<int>(err);
}

// The number of partials a row of nvec accesses takes.
extern "C" int cg_update_chunks(int64_t nvec) {
  return static_cast<int>(chunks_of(nvec));
}
