// B1: one even-odd hopping block, H_oe (out_parity 1) or H_eo (0), with an
// optional fused axpy epilogue out = psi0 + coeff * hop.
//
// Replaces the Pallas TPU kernel hop_block_planar
// (src/repro/kernels/wilson_stencil.py, pallas_call at line 481; body
// _hop_kernel -> _hop_plane).  The TPU version walks a sequential (T, Z)
// grid of (Y, Xh) site planes and fetches x/y neighbours by in-register
// rolls; here one thread owns one output site and reads its 8 neighbours
// directly (the parity-masked x shift becomes an index choice).
//
// Bound on an H100: memory.  At 1320 flops per site against ~770 bytes per
// site (f32, full links: 24 floats in, 24 out, 8 links of 18 floats) the
// kernel needs ~1.7 flop/byte, far under the card's ~20 flop/byte f32
// ridge.  The design does the least that serves that bound: every
// component-plane load of a warp is one contiguous run (consecutive threads
// own consecutive xh), each link is read and expanded once per site and
// reused for the whole right-hand-side block, compressed links (12 or 8
// planes) trade bytes for in-register flops, and neighbour re-reads are left
// to L1/L2.  Periodic, single-shard (halo mode is not ported).
#include "wilson_plane.cuh"

namespace {

using wilson::Geom;

template <typename R, int GC, int NB>
__global__ void __launch_bounds__(wilson::kBlockThreads, wilson::kMinBlocksPerSM)
    hop_kernel(const R* __restrict__ u_out, const R* __restrict__ u_in,
               const R* src, const R* psi0, R* out, Geom g, int nrhs,
               int out_parity, int tz_par, R coeff) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= g.sites) return;
  wilson::hop_site_store<R, GC, NB>(u_out, u_in, src, psi0, out, g, nrhs, idx,
                                    out_parity, tz_par, coeff);
}

struct HopLaunch {
  const void* u_out;
  const void* u_in;
  const void* src;
  const void* psi0;
  void* out;
  Geom g;
  int nrhs, out_parity, tz_par;
  double coeff;
  cudaStream_t stream;

  template <typename R, int GC, int NB>
  cudaError_t run() {
    const unsigned blocks = static_cast<unsigned>(
        (g.sites + wilson::kBlockThreads - 1) / wilson::kBlockThreads);
    hop_kernel<R, GC, NB><<<blocks, wilson::kBlockThreads, 0, stream>>>(
        static_cast<const R*>(u_out), static_cast<const R*>(u_in),
        static_cast<const R*>(src), static_cast<const R*>(psi0),
        static_cast<R*>(out), g, nrhs, out_parity, tz_par,
        static_cast<R>(coeff));
    return cudaGetLastError();
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes.  psi0 may be null (no axpy).
// itemsize is 4 (float) or 8 (double); gc is 18, 12 or 8.  Returns the
// cudaError_t of the launch (0 on success).  Launches on `stream` and does
// not synchronise.
extern "C" int wilson_hop_launch(const void* u_out, const void* u_in,
                                 const void* src, const void* psi0, void* out,
                                 int T, int Z, int Y, int Xh, int nrhs, int gc,
                                 int itemsize, int out_parity, int tz_par,
                                 double coeff, int device, void* stream) {
  wilson::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (T < 1 || Z < 1 || Y < 1 || Xh < 1) return cudaErrorInvalidValue;
  HopLaunch l{u_out,  u_in,       src,    psi0,  out,
              wilson::make_geom(T, Z, Y, Xh), nrhs, out_parity & 1,
              tz_par & 1, coeff, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(wilson::dispatch(itemsize, gc, nrhs, l));
}
