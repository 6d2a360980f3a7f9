// B2: the even-odd preconditioned operator Dhat psi_e =
// psi_e - kappa^2 H_eo H_oe psi_e in ONE launch.
//
// Replaces the Pallas TPU kernel dhat_planar_fused
// (src/repro/kernels/wilson_stencil.py, pallas_call at line 673; body
// _dhat_kernel).  The TPU version runs a sequential grid (2, T, Z)
// (dimension_semantics all "arbitrary"), so its pass 0 over every (t, z)
// plane ends before pass 1 starts, and the odd intermediate H_oe psi_e sits
// in VMEM scratch between them.  CUDA blocks run in no order, so this kernel
// is a cooperative launch: a grid sized to what fits on the card at once
// (occupancy x SM count) walks all sites with a grid-stride loop in pass 0,
// writing H_oe psi_e to a scratch spinor in device memory, then
// cooperative_groups::this_grid().sync() makes every write visible before
// pass 1 reads the z/t neighbour planes that other blocks produced.  Without
// the barrier the result would be wrong only some of the time.
//
// Bound on an H100: memory, as for the hop block (wilson_hop.cu): two hops at
// ~1.7 flop/byte each.  The function itself must move psi_e in, Dhat psi_e
// out, and both gauge parities once.  The scratch (3 MiB at 16^4 f32) is
// written and read back once; on a 50 MB L2 it can stay on chip between the
// passes, which is what the fused launch buys over two hop launches besides
// one launch overhead.  Both passes share the hop device code of
// wilson_plane.cuh.
#include <cooperative_groups.h>

#include "wilson_plane.cuh"

namespace cg = cooperative_groups;

namespace {

using wilson::Geom;

std::atomic<int> g_sm_count[wilson::kMaxDevices];

template <typename R, int GC, int NB>
__global__ void __launch_bounds__(wilson::kBlockThreads, wilson::kMinBlocksPerSM)
    dhat_fused_kernel(const R* __restrict__ u_e, const R* __restrict__ u_o,
                      const R* psi, R* tmp, R* out, Geom g, int nrhs,
                      int tz_par, R kappa2) {
  cg::grid_group grid = cg::this_grid();
  const int64_t start =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // Pass 0: tmp = H_oe psi_e (odd output sites; odd links out, even in).
  for (int64_t idx = start; idx < g.sites; idx += stride)
    wilson::hop_site_store<R, GC, NB>(u_o, u_e, psi, nullptr, tmp, g, nrhs,
                                      idx, 1, tz_par, R(0));
  grid.sync();
  // Pass 1: out = psi_e - kappa^2 H_eo tmp.
  for (int64_t idx = start; idx < g.sites; idx += stride)
    wilson::hop_site_store<R, GC, NB>(u_e, u_o, tmp, psi, out, g, nrhs, idx,
                                      0, tz_par, -kappa2);
}

struct DhatLaunch {
  const void* u_e;
  const void* u_o;
  const void* psi;
  void* tmp;
  void* out;
  Geom g;
  int nrhs, tz_par;
  double kappa2;
  int device;
  cudaStream_t stream;

  template <typename R, int GC, int NB>
  cudaError_t run() {
    auto kernel = dhat_fused_kernel<R, GC, NB>;
    // Occupancy of this instantiation and the SM count: queried on the
    // first launch per device, then read from the caches.
    static std::atomic<int> per_sm_cache[wilson::kMaxDevices];
    int per_sm = 0, sms = 0;
    cudaError_t err = wilson::cached_per_device(
        per_sm_cache, device, &per_sm, [&](int* v) {
          return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              v, kernel, wilson::kBlockThreads, 0);
        });
    if (err != cudaSuccess) return err;
    err = wilson::cached_per_device(g_sm_count, device, &sms, [&](int* v) {
      return cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount,
                                    device);
    });
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    const int64_t needed =
        (g.sites + wilson::kBlockThreads - 1) / wilson::kBlockThreads;
    const int64_t resident = static_cast<int64_t>(per_sm) * sms;
    const int grid_blocks =
        static_cast<int>(needed < resident ? needed : resident);
    const R* ue = static_cast<const R*>(u_e);
    const R* uo = static_cast<const R*>(u_o);
    const R* p = static_cast<const R*>(psi);
    R* t = static_cast<R*>(tmp);
    R* o = static_cast<R*>(out);
    R k2 = static_cast<R>(kappa2);
    Geom geom = g;
    int n = nrhs, par = tz_par;
    void* args[] = {&ue, &uo, &p, &t, &o, &geom, &n, &par, &k2};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                      dim3(grid_blocks),
                                      dim3(wilson::kBlockThreads), args, 0,
                                      stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes.  tmp is caller-allocated scratch
// of the same shape as psi.  itemsize is 4 or 8; gc is 18, 12 or 8.  Returns
// the cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int wilson_dhat_fused_launch(const void* u_e, const void* u_o,
                                        const void* psi, void* tmp, void* out,
                                        int T, int Z, int Y, int Xh, int nrhs,
                                        int gc, int itemsize, int tz_par,
                                        double kappa2, int device,
                                        void* stream) {
  wilson::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (T < 1 || Z < 1 || Y < 1 || Xh < 1) return cudaErrorInvalidValue;
  DhatLaunch l{u_e,    u_o,        psi,    tmp,    out,
               wilson::make_geom(T, Z, Y, Xh), nrhs, tz_par & 1, kappa2,
               device, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(wilson::dispatch(itemsize, gc, nrhs, l));
}
