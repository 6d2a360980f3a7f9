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
// the grid running in order.
//
// Here the schedule is a list of tasks, step by step, the produce tasks of
// a step before its consume tasks; a task is one tile of sites of a t-row
// times one group of sources (wilson_site_tile.cuh, shared with B1 and
// B2).  One
// cooperative launch (every block resident, so spinning cannot deadlock)
// deals the tasks out round robin; each block runs its tasks in list order.
// Tasks order themselves by counters in device memory instead of
// whole-grid barriers: one counter per (ring slot, source group, z plane)
// counts the finished produce tiles that cover the plane, and one per
// ((step - 3) % window, source group, z plane) the finished consume tiles.
//   - A consume task of step s waits until the planes it reads (its own
//     and one on either side, periodic in z; x and y neighbours lie in the
//     same plane) are complete in the rows of steps s-1, s-2 and s-3.
//   - A produce task of step s overwrites slot s % window, which the
//     consume steps s-window+1 .. s-window+3 read; it waits until the
//     consumers of the same planes are done (the write-after-read hazard).
// Every dependency points to an earlier task of the list, so the earliest
// unfinished task can always run.  Produce step p is the
// (p / window + 1)-th use of its slot (consume step c the
// ((c - 3) / window + 1)-th), so a plane of it is complete when the
// plane's counter reaches that many times the tiles covering the plane;
// no tile of a later use can finish before every tile of an earlier one
// on the same plane, because the dependencies chain them.  A producer
// publishes a tile with __threadfence() and atomic adds after its block's
// stores; consumers spin on acquire loads.  The last block to finish zeroes
// the counters, so the next launch on the same buffer finds them at 0
// without a memset; launches that may overlap (other streams) need their
// own buffers, and the wrapper keeps one per stream.
//
// A ring above 4 rows spaces a slot's reuse further from its readers, so
// producers seldom wait for them.  The ring, (nrhs, window, Z, 24, Y, Xh), and the flags
// are independent of T.  The ring is read through plain pointers (not
// __restrict__ / __ldg) because it is written in the same launch.
//
// Bound on an H100: memory, as for B2: the function must move psi_e in,
// Dhat psi_e out, and both gauge parities once.  The ring (1.6 MB at 16^4
// f32 with one source, 25 MB at 64x32x32x16, 8 rows) stays in the 50 MB
// L2 at any T, where B2's full-lattice scratch (101 MB at 64x32x32x16)
// does not.  What it costs: 2 recomputed rows of H_oe and the counter
// traffic.
#include <cooperative_groups.h>

#include "wilson_site_tile.cuh"

namespace {

using wilson::Geom;
using wilson::tile::Shape;
using Flag = unsigned long long;

// The counters: [0] blocks finished in this launch, then the produce
// counters [window][groups][Z] and the consume counters [window][groups][Z]
// (kernels/geometry.py, stream_flag_words).
constexpr int kFlagHeader = 1;

__device__ __forceinline__ Flag ld_acquire(const Flag* p) {
  Flag v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The z planes a tile covers, [za, zb].
struct Planes {
  int za, zb;
};

__device__ __forceinline__ Planes tile_planes(const Geom& g, const Shape& sh,
                                              int tile) {
  const int plane = static_cast<int>(g.plane);
  const int first = tile * sh.S;
  const int last = min(first + sh.S, g.Z * plane) - 1;
  return {first / plane, last / plane};
}

// Tiles that cover plane z.
__device__ __forceinline__ int tiles_on_plane(const Geom& g, const Shape& sh,
                                              int z) {
  const int plane = static_cast<int>(g.plane);
  return ((z + 1) * plane - 1) / sh.S - z * plane / sh.S + 1;
}

// Wait until, for each of the n awaited uses (counter base[i] of one slot
// and group, use number uses[i]), the planes za-1 .. zb+1 (periodic) are
// complete; the block's threads split the counters, and only the threads
// that spun fence before the barrier that hands the stores they saw
// published to the whole block.
__device__ __forceinline__ void wait_planes(const Geom& g, const Shape& sh,
                                            const Flag* const* base,
                                            const int* uses, int n,
                                            Planes pl) {
  const int span = min(pl.zb - pl.za + 3, g.Z);
  if (static_cast<int>(threadIdx.x) < n * span) {
    for (int i = threadIdx.x; i < n * span; i += blockDim.x) {
      const int j = i / span;
      int z = pl.za - 1 + i % span;
      z = z < 0 ? z + g.Z : (z >= g.Z ? z - g.Z : z);
      const Flag want =
          static_cast<Flag>(uses[j]) * tiles_on_plane(g, sh, z);
      while (ld_acquire(base[j] + z) < want) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Count one finished tile on each plane it covers: the block's stores
// (ended by hop_tile's barrier) first.
__device__ __forceinline__ void publish(Flag* base, Planes pl) {
  if (threadIdx.x == 0) {
    __threadfence();
    for (int z = pl.za; z <= pl.zb; ++z) atomicAdd(base + z, Flag(1));
  }
}

template <typename R, int GC, int D>
__global__ void __launch_bounds__(wilson::tile::kMaxThreads,
                                  wilson::tile::MinBlocks<R>::value)
    dhat_stream_kernel(const R* __restrict__ u_e, const R* __restrict__ u_o,
                       const R* __restrict__ psi, R* ring, R* out,
                       Flag* flags, Geom g, Shape sh, int nrhs, int window,
                       int tz_par, R kappa2) {
  extern __shared__ __align__(16) char smem[];
  const int64_t per_slot = static_cast<int64_t>(sh.groups) * g.Z;
  Flag* pcount = flags + kFlagHeader;
  Flag* ccount = pcount + window * per_slot;
  const int per_step = sh.tiles * sh.groups;
  const int64_t rows = wilson::row_elems(g);
  const int64_t psi_rhs = g.sites * wilson::kSpinorComps;
  const int64_t ring_rhs = static_cast<int64_t>(window) * rows;
  // Steps 0..2 produce only, 3..T+1 produce then consume, T+2 consumes.
  const int tasks = (2 * g.T + 2) * per_step;
  for (int w = blockIdx.x; w < tasks; w += gridDim.x) {
    int s, k;
    bool produce;
    if (w < 3 * per_step) {
      s = w / per_step;
      k = w % per_step;
      produce = true;
    } else {
      const int v = w - 3 * per_step;
      s = 3 + v / (2 * per_step);
      k = v % (2 * per_step);
      produce = s <= g.T + 1 && k < per_step;
      if (!produce && s <= g.T + 1) k -= per_step;
    }
    const int tile = k % sh.tiles, grp = k / sh.tiles;
    const int r0 = grp * sh.G;
    const int nr = nrhs - r0 < sh.G ? nrhs - r0 : sh.G;
    const Planes pl = tile_planes(g, sh, tile);
    // The uses this task waits for: their counters and use numbers.
    const Flag* base[3];
    int uses[3];
    int n = 0;
    for (int j = 1; j <= 3; ++j) {
      // Produce steps count from 0, consume steps from 3.
      const int use = produce ? s - window + j - 3 : s - j;
      if (use < 0) continue;
      base[n] = (produce ? ccount : pcount) + (use % window) * per_slot +
                grp * g.Z;
      uses[n] = use / window + 1;
      ++n;
    }
    wait_planes(g, sh, base, uses, n, pl);
    if (produce) {
      // ring[s % window] = H_oe psi_e at source row (s-1) % T.
      const int t = (s + g.T - 1) % g.T;
      const int tf = t + 1 == g.T ? 0 : t + 1;
      const int tb = t == 0 ? g.T - 1 : t - 1;
      const R* p = psi + r0 * psi_rhs;
      wilson::tile::hop_tile<R, GC, D>(
          smem, g, sh, u_o, u_e, p + t * rows, p + tf * rows, p + tb * rows,
          psi_rhs, ring + r0 * ring_rhs + (s % window) * rows, nullptr,
          ring_rhs, t, tile * sh.S, nr, 1, tz_par, R(0));
      publish(pcount + (s % window) * per_slot + grp * g.Z, pl);
    } else {
      // out = psi_e - kappa^2 H_eo ring at output row (s-3) % T, whose
      // rows t, t+1, t-1 sit in slots (s-2), (s-1), (s-3) % window.
      const int t = (s - 3) % g.T;
      const R* q = ring + r0 * ring_rhs;
      const int64_t o = r0 * psi_rhs + t * rows;
      wilson::tile::hop_tile<R, GC, D>(
          smem, g, sh, u_e, u_o, q + ((s - 2) % window) * rows,
          q + ((s - 1) % window) * rows, q + ((s - 3) % window) * rows,
          ring_rhs, out + o, psi + o, psi_rhs, t, tile * sh.S, nr, 0, tz_par,
          -kappa2);
      publish(ccount + ((s - 3) % window) * per_slot + grp * g.Z, pl);
    }
  }
  // The last block to finish zeroes the counters for the next launch.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(flags, Flag(1)) == gridDim.x - 1) {
      const int64_t words = kFlagHeader + 2 * window * per_slot;
      for (int64_t i = 0; i < words; ++i) flags[i] = 0;
      __threadfence();
    }
  }
}

struct DhatStreamLaunch {
  const void* u_e;
  const void* u_o;
  const void* psi;
  void* ring;
  void* out;
  void* flags;
  Geom g;
  Shape sh;
  int nrhs, window, tz_par;
  double kappa2;
  int threads, grid_blocks, smem;
  cudaStream_t stream;

  template <typename R, int GC, int D>
  cudaError_t run() {
    auto kernel = dhat_stream_kernel<R, GC, D>;
    const R* ue = static_cast<const R*>(u_e);
    const R* uo = static_cast<const R*>(u_o);
    const R* p = static_cast<const R*>(psi);
    R* rg = static_cast<R*>(ring);
    R* o = static_cast<R*>(out);
    Flag* f = static_cast<Flag*>(flags);
    R k2 = static_cast<R>(kappa2);
    Geom geom = g;
    Shape shape = sh;
    int n = nrhs, w = window, par = tz_par;
    void* args[] = {&ue, &uo, &p, &rg, &o, &f, &geom, &shape, &n, &w, &par,
                    &k2};
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
    return wilson::tile::blocks_per_sm(dhat_stream_kernel<R, GC, D>, threads,
                                       smem, device, per_sm);
  }
};

}  // namespace

// Blocks of the (itemsize, gc, D) instantiation that fit one SM at
// `threads` threads and `smem` bytes of dynamic shared memory, into
// *per_sm; also lifts the instantiation's shared-memory limit, which the
// launch needs above 48 KB.  Returns the cudaError_t (0 on success).
extern "C" int wilson_dhat_stream_occupancy(int gc, int itemsize,
                                            int dgroups, int threads,
                                            int smem, int device,
                                            int* per_sm) {
  wilson::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  Occupancy o{threads, smem, device, per_sm};
  return static_cast<int>(wilson::tile::dispatch(itemsize, gc, dgroups, o));
}

// Plain C entry point, loaded with ctypes.  ring is caller-allocated
// scratch of nrhs * window * Z * 24 * Y * Xh elements, window >= 4; flags
// is a zero-initialised buffer of 1 + 2 * window * groups * Z 64-bit words,
// which the kernel leaves zeroed, so a caller reuses it for every launch on
// one stream.  itemsize is 4 or 8; gc is 18, 12 or 8; the geometry as for
// wilson_dhat_fused_launch.  Returns the cudaError_t of the launch (0 on
// success); does not synchronise.
extern "C" int wilson_dhat_stream_launch(
    const void* u_e, const void* u_o, const void* psi, void* ring, void* out,
    void* flags, int T, int Z, int Y, int Xh, int nrhs, int window, int gc,
    int itemsize, int tz_par, double kappa2, int dgroups, int G, int S,
    int groups, int tiles, int threads, int grid_blocks, int smem,
    int device, void* stream) {
  wilson::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (T < 1 || Z < 1 || Y < 1 || Xh < 1 || nrhs < 1 || window < 4 ||
      grid_blocks < 1)
    return cudaErrorInvalidValue;
  const Shape sh{G, S, groups, tiles};
  cudaError_t err = wilson::tile::check_shape(sh, dgroups, threads,
                                              itemsize, smem, nrhs);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geom g = wilson::make_geom(T, Z, Y, Xh);
  if (static_cast<int64_t>(tiles) * S < g.Z * g.plane)
    return cudaErrorInvalidValue;
  DhatStreamLaunch l{u_e,    u_o,     psi,        ring,   out,
                     flags,  g,       sh,         nrhs,   window,
                     tz_par & 1, kappa2, threads, grid_blocks, smem,
                     static_cast<cudaStream_t>(stream)};
  return static_cast<int>(wilson::tile::dispatch(itemsize, gc, dgroups, l));
}
