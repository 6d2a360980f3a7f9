// B3: the even-odd preconditioned operator Dhat psi_e =
// psi_e - kappa^2 H_eo H_oe psi_e in ONE launch, with the odd intermediate
// held in a ring of `window` t-rows instead of a full-lattice scratch.
//
// Replaces the Pallas TPU kernel dhat_planar_fused_stream
// (src/repro/kernels/wilson_stencil.py, pallas_call at line 992; body
// _dhat_stream_kernel).  The TPU version walks a sequential grid (T+3, Z)
// (dimension_semantics all "arbitrary"): step s produces H_oe psi_e of
// source row (s-1) % T into ring slot s % window (for s <= T+1) and
// consumes output row (s-3) % T from slots (s-3 .. s-1) % window (for
// s >= 3).  Rows T-1 and 0 are produced twice, so the periodic t-wrap of
// the consume stage reads freshly produced slots.  Its correctness rests on
// the grid running in order, since a consume step reads the z+-1 planes of
// ring rows that other steps produced.
//
// CUDA blocks run in no order, so this kernel is one cooperative launch,
// like B2 (wilson_dhat_fused.cu): a grid sized to what fits on the card at
// once walks s = 0 .. T+2, and cooperative_groups::this_grid().sync()
// separates the steps (T+2 barriers).  Inside a step the produce stage
// writes slot s % window while the consume stage reads the three slots
// before it; with window >= 4 these are disjoint, so both stages run in the
// same phase, as one grid-stride loop over 2 x (Z*Y*Xh sites x RHS blocks
// of NB) work items.  Mapping threads over RHS blocks as well as sites
// matters: one t-row at 16^4 is only 2048 sites, so a phase alone fills
// few of the 132 SMs; 12 right-hand sides give three times the threads.
// The ring lives in device memory, (nrhs, window, Z, 24, Y, Xh), and is
// read through plain pointers (not __restrict__ / __ldg) because it is
// written in the same launch.
//
// Bound on an H100: memory, as for B2: the function must move psi_e in,
// Dhat psi_e out, and both gauge parities once.  The ring (0.75 MiB at
// 16^4 f32, 12 MiB at 64x32x32x16) stays in the 50 MB L2 at any T, where
// B2's full-lattice scratch (96 MiB at 64x32x32x16) does not.  What it
// costs: 2 recomputed rows of H_oe and T+2 grid barriers per launch.  Both
// stages share the hop device code of wilson_plane.cuh.
#include <cooperative_groups.h>

#include "wilson_plane.cuh"

namespace cg = cooperative_groups;

namespace {

using wilson::Geom;

std::atomic<int> g_sm_count[wilson::kMaxDevices];

template <typename R, int GC, int NB>
__global__ void __launch_bounds__(wilson::kBlockThreads, wilson::kMinBlocksPerSM)
    dhat_stream_kernel(const R* __restrict__ u_e, const R* __restrict__ u_o,
                       const R* __restrict__ psi, R* ring, R* out, Geom g,
                       int nrhs, int window, int tz_par, R kappa2) {
  cg::grid_group grid = cg::this_grid();
  const int64_t start =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t row_sites = static_cast<int64_t>(g.Z) * g.plane;
  const int64_t items = row_sites * ((nrhs + NB - 1) / NB);
  const int64_t rows = wilson::row_elems(g);
  const int64_t psi_rhs = g.sites * wilson::kSpinorComps;
  const int64_t ring_rhs = static_cast<int64_t>(window) * rows;
  for (int s = 0; s <= g.T + 2; ++s) {
    const bool produce = s <= g.T + 1;
    const bool consume = s >= 3;
    const int64_t n = (produce ? items : 0) + (consume ? items : 0);
    for (int64_t i = start; i < n; i += stride) {
      const bool is_produce = produce && i < items;
      const int64_t j = produce && !is_produce ? i - items : i;
      const int r0 = static_cast<int>(j / row_sites) * NB;
      const int64_t site = j % row_sites;
      const int xh = static_cast<int>(site % g.Xh);
      const int y = static_cast<int>((site / g.Xh) % g.Y);
      const int z = static_cast<int>(site / g.plane);
      const int nb = nrhs - r0 < NB ? nrhs - r0 : NB;
      const int64_t at = wilson::row_offset(g, z, y, xh);
      // Both stages are one hop and one store; they differ in operands.
      const R *u_out, *u_in, *src_c, *src_tf, *src_tb, *psi0;
      int64_t src_stride, dst_stride;
      int t, out_parity;
      R* dst;
      R coeff;
      if (is_produce) {
        // ring[s % window] = H_oe psi_e at source row (s-1) % T.
        t = (s + g.T - 1) % g.T;
        const int tf = t + 1 == g.T ? 0 : t + 1;
        const int tb = t == 0 ? g.T - 1 : t - 1;
        const R* p = psi + r0 * psi_rhs;
        u_out = u_o;
        u_in = u_e;
        src_c = p + t * rows;
        src_tf = p + tf * rows;
        src_tb = p + tb * rows;
        src_stride = psi_rhs;
        out_parity = 1;
        dst = ring + r0 * ring_rhs + (s % window) * rows + at;
        dst_stride = ring_rhs;
        psi0 = nullptr;
        coeff = R(0);
      } else {
        // out = psi_e - kappa^2 H_eo ring at output row (s-3) % T, whose
        // rows t, t+1, t-1 sit in slots (s-2), (s-1), (s-3) % window.
        t = (s - 3) % g.T;
        const R* q = ring + r0 * ring_rhs;
        u_out = u_e;
        u_in = u_o;
        src_c = q + ((s - 2) % window) * rows;
        src_tf = q + ((s - 1) % window) * rows;
        src_tb = q + ((s - 3) % window) * rows;
        src_stride = ring_rhs;
        out_parity = 0;
        const int64_t o = r0 * psi_rhs + t * rows + at;
        dst = out + o;
        dst_stride = psi_rhs;
        psi0 = psi + o;
        coeff = -kappa2;
      }
      R acc[NB][24];
      wilson::hop_site<R, GC, NB>(u_out, u_in, src_c, src_tf, src_tb,
                                  src_stride, g, t, z, y, xh, nb,
                                  out_parity, tz_par, acc);
      wilson::store_site<R, NB>(dst, psi0, dst_stride, g.plane, nb, coeff,
                                acc);
    }
    if (s < g.T + 2) grid.sync();
  }
}

struct DhatStreamLaunch {
  const void* u_e;
  const void* u_o;
  const void* psi;
  void* ring;
  void* out;
  Geom g;
  int nrhs, window, tz_par;
  double kappa2;
  int device;
  cudaStream_t stream;

  template <typename R, int GC, int NB>
  cudaError_t run() {
    auto kernel = dhat_stream_kernel<R, GC, NB>;
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
    // The widest step has both stages: 2 x (row sites x RHS blocks).
    const int64_t row_sites = static_cast<int64_t>(g.Z) * g.plane;
    const int64_t work = 2 * row_sites * ((nrhs + NB - 1) / NB);
    const int64_t needed =
        (work + wilson::kBlockThreads - 1) / wilson::kBlockThreads;
    const int64_t resident = static_cast<int64_t>(per_sm) * sms;
    const int grid_blocks =
        static_cast<int>(needed < resident ? needed : resident);
    const R* ue = static_cast<const R*>(u_e);
    const R* uo = static_cast<const R*>(u_o);
    const R* p = static_cast<const R*>(psi);
    R* rg = static_cast<R*>(ring);
    R* o = static_cast<R*>(out);
    R k2 = static_cast<R>(kappa2);
    Geom geom = g;
    int n = nrhs, w = window, par = tz_par;
    void* args[] = {&ue, &uo, &p, &rg, &o, &geom, &n, &w, &par, &k2};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                      dim3(grid_blocks),
                                      dim3(wilson::kBlockThreads), args, 0,
                                      stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes.  ring is caller-allocated
// scratch of nrhs * window * Z * 24 * Y * Xh elements; window >= 4 (the
// wrapper refuses less).  itemsize is 4 or 8; gc is 18, 12 or 8.  Returns
// the cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int wilson_dhat_stream_launch(const void* u_e, const void* u_o,
                                         const void* psi, void* ring,
                                         void* out, int T, int Z, int Y,
                                         int Xh, int nrhs, int window,
                                         int gc, int itemsize, int tz_par,
                                         double kappa2, int device,
                                         void* stream) {
  wilson::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (T < 1 || Z < 1 || Y < 1 || Xh < 1 || window < 4)
    return cudaErrorInvalidValue;
  DhatStreamLaunch l{u_e,    u_o,    psi,        ring,
                     out,    wilson::make_geom(T, Z, Y, Xh),
                     nrhs,   window, tz_par & 1, kappa2,
                     device, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(wilson::dispatch(itemsize, gc, nrhs, l));
}
