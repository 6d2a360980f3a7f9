// B1: one even-odd hopping block, H_oe (out_parity 1) or H_eo (0), with an
// optional fused axpy epilogue out = psi0 + coeff * hop, periodic or on
// halo-extended arrays (halo mode, the distributed local step).
//
// Replaces the Pallas TPU kernel hop_block_planar
// (src/repro/kernels/wilson_stencil.py, pallas_call at line 481; body
// _hop_kernel -> _hop_plane, halo index maps in _build_specs).  The TPU
// version walks a sequential (T, Z) grid of (Y, Xh) site planes and
// fetches x/y neighbours by in-register rolls.  Here a block takes one
// task, (t-row, tile of sites, source group), and runs the tile routine
// of wilson_site_tile.cuh that B2 and B3 run for each of their tasks: the
// tasks do not depend on each other, so the launch is a plain one with one
// block per task and no persistent loop.
//
// Bound on an H100: memory.  At 1320 flops per site against ~770 bytes per
// site (f32, full links: 24 floats in, 24 out, 8 links of 18 floats) the
// kernel needs ~1.7 flop/byte, far under the card's ~20 flop/byte f32
// ridge.  What the design does about it (wilson_site_tile.cuh): the tile's
// links are copied into shared memory once, 16 bytes a copy where their
// runs allow, and expanded there once if compressed, for every source of
// the group, so link bytes do not grow with the sources; threads range
// over (site, source, direction group) with one accumulator each, so the
// f32 instantiations need no spills at 168 registers; consecutive threads
// read consecutive sites of a component plane.  The tile is smaller than
// B2's where B2's would leave the card short of blocks
// (kernels/geometry.py, hop_geometry); the direction split D is B2's, so
// the two-launch Dhat sums in B2's order.
#include <atomic>

#include "wilson_site_tile.cuh"

namespace {

using wilson::Geom;
using wilson::tile::Shape;

// Block w takes t-row w / (tiles * groups), source group (w / tiles) %
// groups and tile w % tiles.  In halo mode the source has T+2 rows of Z+2
// planes and the output row t reads the source rows t+1 (centre), t+2 and
// t, from their plane 1.
template <typename R, int GC, int D, bool HALO>
__global__ void __launch_bounds__(wilson::tile::kMaxThreads,
                                  wilson::tile::MinBlocks<R>::value)
    hop_kernel(const R* __restrict__ u_out, const R* __restrict__ u_in,
               const R* __restrict__ src, const R* __restrict__ psi0,
               R* __restrict__ out, Geom g, Shape sh, int nrhs,
               int out_parity, int tz_par,
               wilson::compute_t<R> coeff) {
  extern __shared__ __align__(16) char smem[];
  const int per_row = sh.tiles * sh.groups;
  const int w = blockIdx.x;
  const int t = w / per_row;
  const int grp = (w % per_row) / sh.tiles;
  const int tile = w % sh.tiles;
  const int r0 = grp * sh.G;
  const int nr = nrhs - r0 < sh.G ? nrhs - r0 : sh.G;
  const int64_t src_row = static_cast<int64_t>(HALO ? g.Z + 2 : g.Z) *
                          wilson::kSpinorComps * g.plane;
  const int64_t src_rhs = (HALO ? g.T + 2 : g.T) * src_row;
  const int64_t out_rhs = g.sites * wilson::kSpinorComps;
  int tc, tf, tb;
  if (HALO) {
    tc = t + 1;
    tf = t + 2;
    tb = t;
  } else {
    tc = t;
    tf = t + 1 == g.T ? 0 : t + 1;
    tb = t == 0 ? g.T - 1 : t - 1;
  }
  const R* s = src + r0 * src_rhs +
               (HALO ? wilson::kSpinorComps * g.plane : 0);
  const int64_t o = r0 * out_rhs + t * wilson::row_elems(g);
  wilson::tile::hop_tile<R, GC, D, HALO>(
      smem, g, sh, u_out, u_in, s + tc * src_row, s + tf * src_row,
      s + tb * src_row, src_rhs, out + o,
      psi0 != nullptr ? psi0 + o : nullptr, out_rhs, t, tile * sh.S, nr,
      out_parity, tz_par, coeff);
}

struct HopLaunch {
  const void* u_out;
  const void* u_in;
  const void* src;
  const void* psi0;
  void* out;
  Geom g;
  Shape sh;
  int nrhs, halo, out_parity, tz_par;
  double coeff;
  int threads, smem, device;
  cudaStream_t stream;

  template <typename R, int GC, int D, bool HALO>
  cudaError_t launch() {
    auto kernel = hop_kernel<R, GC, D, HALO>;
    // Above 48 KB a block's dynamic shared memory needs the limit lifted,
    // once per instantiation and device.
    static std::atomic<unsigned long long> lifted{0};
    const unsigned long long bit = 1ull << (device & 63);
    if ((lifted.load() & bit) == 0) {
      cudaError_t err = wilson::tile::lift_smem_limit(kernel, device);
      if (err != cudaSuccess) return err;
      lifted.fetch_or(bit);
    }
    const unsigned blocks =
        static_cast<unsigned>(g.T) * sh.tiles * sh.groups;
    kernel<<<blocks, threads, static_cast<size_t>(smem), stream>>>(
        static_cast<const R*>(u_out), static_cast<const R*>(u_in),
        static_cast<const R*>(src), static_cast<const R*>(psi0),
        static_cast<R*>(out), g, sh, nrhs, out_parity, tz_par,
        static_cast<wilson::compute_t<R>>(coeff));
    return cudaGetLastError();
  }

  template <typename R, int GC, int D>
  cudaError_t run() {
    return halo ? launch<R, GC, D, true>() : launch<R, GC, D, false>();
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes.  psi0 may be null (no axpy).
// T, Z, Y, Xh are the output's extents; with halo = 1, src is
// [nrhs][T+2][Z+2][24][Y][Xh] and u_in [4][T+2][Z+2][gc][Y][Xh], while
// u_out, psi0 and out are not extended.  itemsize is 4 (float), 8
// (double) or 2 (bf16, computed in f32); gc is 18, 12 or 8; the geometry
// (dgroups = D, G, S, groups, tiles, threads, smem bytes) comes from
// kernels/geometry.py, hop_geometry;
// the grid is T * tiles * groups blocks.  Returns the cudaError_t of the
// launch (0 on success).  Launches on `stream` and does not synchronise.
extern "C" int wilson_hop_launch(const void* u_out, const void* u_in,
                                 const void* src, const void* psi0, void* out,
                                 int T, int Z, int Y, int Xh, int nrhs, int gc,
                                 int itemsize, int halo, int out_parity,
                                 int tz_par, double coeff, int dgroups, int G,
                                 int S, int groups, int tiles, int threads,
                                 int smem, int device, void* stream) {
  wilson::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (T < 1 || Z < 1 || Y < 1 || Xh < 1 || nrhs < 1)
    return cudaErrorInvalidValue;
  const Shape sh{G, S, groups, tiles};
  cudaError_t err = wilson::tile::check_shape(sh, dgroups, threads,
                                              itemsize, smem, nrhs);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geom g = wilson::make_geom(T, Z, Y, Xh);
  if (static_cast<int64_t>(tiles) * S < g.Z * g.plane ||
      static_cast<int64_t>(T) * tiles * groups > 0x7fffffff)
    return cudaErrorInvalidValue;
  HopLaunch l{u_out, u_in, src, psi0, out, g, sh, nrhs, halo != 0,
              out_parity & 1, tz_par & 1, coeff, threads, smem, device,
              static_cast<cudaStream_t>(stream)};
  return static_cast<int>(wilson::tile::dispatch(itemsize, gc, dgroups, l));
}
