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
// (occupancy x SM count) walks the tasks of pass 0, writing H_oe psi_e to a
// scratch spinor in device memory, then cooperative_groups::this_grid()
// .sync() makes every write visible before pass 1 reads the z/t neighbour
// planes that other blocks produced.
//
// Bound on an H100: memory.  Two hops at ~1.7 flop/byte each, far under
// the card's ~20 flop/byte f32 ridge; the function must move psi_e in,
// Dhat psi_e out, and both gauge parities once.  The scratch (3 MiB at 16^4
// f32) is written and read back once and can stay in the 50 MB L2.  What
// the design does about the bound (wilson_site_tile.cuh): a task is a tile
// of sites of one t-row times a group of up to 4 sources, one block each;
// threads range over (site, source, direction group); the tile's links are
// copied into shared memory once with cp.async (and expanded there once if
// compressed) and serve every source of the group, so link bytes do not
// grow with the sources; one accumulator per thread keeps the f32
// instantiations free of spills at 168 registers.
#include <cooperative_groups.h>

#include "wilson_site_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using wilson::Geom;
using wilson::tile::Shape;

template <typename R, int GC, int D>
__global__ void __launch_bounds__(wilson::tile::kMaxThreads,
                                  wilson::tile::MinBlocks<R>::value)
    dhat_fused_kernel(const R* __restrict__ u_e, const R* __restrict__ u_o,
                      const R* psi, R* tmp, R* out, Geom g, Shape sh,
                      int nrhs, int tz_par,
                      wilson::compute_t<R> kappa2) {
  extern __shared__ __align__(16) char smem[];
  cg::grid_group grid = cg::this_grid();
  const int64_t rows = wilson::row_elems(g);
  const int64_t psi_rhs = g.sites * wilson::kSpinorComps;
  const int per_row = sh.tiles * sh.groups;
  const int tasks = g.T * per_row;
  for (int pass = 0; pass < 2; ++pass) {
    for (int w = blockIdx.x; w < tasks; w += gridDim.x) {
      const int tile = w % sh.tiles;
      const int grp = (w / sh.tiles) % sh.groups;
      const int t = w / per_row;
      const int tf = t + 1 == g.T ? 0 : t + 1;
      const int tb = t == 0 ? g.T - 1 : t - 1;
      const int r0 = grp * sh.G;
      const int nr = nrhs - r0 < sh.G ? nrhs - r0 : sh.G;
      const int64_t base = r0 * psi_rhs;
      if (pass == 0) {
        // tmp = H_oe psi_e (odd output sites; odd links out, even in).
        const R* p = psi + base;
        wilson::tile::hop_tile<R, GC, D>(
            smem, g, sh, u_o, u_e, p + t * rows, p + tf * rows,
            p + tb * rows, psi_rhs, tmp + base + t * rows, nullptr, psi_rhs,
            t, tile * sh.S, nr, 1, tz_par, 0);
      } else {
        // out = psi_e - kappa^2 H_eo tmp.
        const R* q = tmp + base;
        wilson::tile::hop_tile<R, GC, D>(
            smem, g, sh, u_e, u_o, q + t * rows, q + tf * rows,
            q + tb * rows, psi_rhs, out + base + t * rows,
            psi + base + t * rows, psi_rhs, t, tile * sh.S, nr, 0, tz_par,
            -kappa2);
      }
    }
    if (pass == 0) grid.sync();
  }
}

struct DhatLaunch {
  const void* u_e;
  const void* u_o;
  const void* psi;
  void* tmp;
  void* out;
  Geom g;
  Shape sh;
  int nrhs, tz_par;
  double kappa2;
  int threads, grid_blocks, smem;
  cudaStream_t stream;

  template <typename R, int GC, int D>
  cudaError_t run() {
    auto kernel = dhat_fused_kernel<R, GC, D>;
    const R* ue = static_cast<const R*>(u_e);
    const R* uo = static_cast<const R*>(u_o);
    const R* p = static_cast<const R*>(psi);
    R* t = static_cast<R*>(tmp);
    R* o = static_cast<R*>(out);
    using C = wilson::compute_t<R>;
    C k2 = static_cast<C>(kappa2);
    Geom geom = g;
    Shape shape = sh;
    int n = nrhs, par = tz_par;
    void* args[] = {&ue, &uo, &p, &t, &o, &geom, &shape, &n, &par, &k2};
    cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(kernel), dim3(grid_blocks), dim3(threads),
        args, static_cast<size_t>(smem), stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
};

struct Occupancy {
  int threads, smem, device;
  int* per_sm;

  template <typename R, int GC, int D>
  cudaError_t run() {
    return wilson::tile::blocks_per_sm(dhat_fused_kernel<R, GC, D>, threads,
                                       smem, device, per_sm);
  }
};

}  // namespace

// Blocks of the (itemsize, gc, D) instantiation that fit one SM at
// `threads` threads and `smem` bytes of dynamic shared memory, into
// *per_sm; also lifts the instantiation's shared-memory limit, which the
// launch needs above 48 KB.  Returns the cudaError_t (0 on success).
extern "C" int wilson_dhat_fused_occupancy(int gc, int itemsize, int dgroups,
                                           int threads, int smem, int device,
                                           int* per_sm) {
  wilson::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  Occupancy o{threads, smem, device, per_sm};
  return static_cast<int>(wilson::tile::dispatch(itemsize, gc, dgroups, o));
}

// Plain C entry point, loaded with ctypes.  tmp is caller-allocated scratch
// of the same shape as psi.  itemsize is 4 (float), 8 (double) or 2 (bf16:
// bf16 tensors, scratch included, computed in f32); gc is 18, 12 or 8; the
// geometry (dgroups = D, G, S, groups, tiles, threads, grid blocks, smem
// bytes) comes from kernels/geometry.py, the grid no larger
// than what the occupancy entry reports times the SM count.  Returns the
// cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int wilson_dhat_fused_launch(
    const void* u_e, const void* u_o, const void* psi, void* tmp, void* out,
    int T, int Z, int Y, int Xh, int nrhs, int gc, int itemsize, int tz_par,
    double kappa2, int dgroups, int G, int S, int groups, int tiles,
    int threads, int grid_blocks, int smem, int device, void* stream) {
  wilson::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (T < 1 || Z < 1 || Y < 1 || Xh < 1 || nrhs < 1 || grid_blocks < 1)
    return cudaErrorInvalidValue;
  const Shape sh{G, S, groups, tiles};
  cudaError_t err = wilson::tile::check_shape(sh, dgroups, threads,
                                              itemsize, smem, nrhs);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geom g = wilson::make_geom(T, Z, Y, Xh);
  if (static_cast<int64_t>(tiles) * S < g.Z * g.plane)
    return cudaErrorInvalidValue;
  DhatLaunch l{u_e,    u_o,     psi,         tmp,
               out,    g,       sh,          nrhs,
               tz_par & 1, kappa2, threads, grid_blocks,
               smem,   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(wilson::tile::dispatch(itemsize, gc, dgroups, l));
}
