// Device code of the three kernels: one hopping block applied to a tile
// of sites of one t-row for a group of right-hand sides, by one thread
// block.  B1 (wilson_hop.cu) runs it once per block; the fused Dhat
// kernels B2 (wilson_dhat_fused.cu) and B3 (wilson_dhat_stream.cu) run it
// for each task of their persistent blocks.
//
// Work items are (site, source, direction group).  The 8 terms of a site
// (4 directions, forward and backward) are split over D threads (D = 1 or
// 2), each summing the directions of its group; the D partial sums meet in
// shared memory before the store.  Sources are a thread dimension, not a
// serial loop, so one thread keeps one 24-component accumulator and does
// not spill.  The block's threads are ordered (d, r, s) with the tile site
// s fastest: consecutive threads load consecutive sites of one component
// plane, and with D > 1 every warp has one direction group (G * S is a
// multiple of 32 then), so the direction switch does not diverge.
//
// Links go through shared memory: the 8 links a site needs (forward at the
// site, backward at its -mu neighbour) are copied once per tile with
// cp.async, compressed links (12 or 8 planes) are expanded there once, in
// place, and the threads of every source of the group read them.  Link
// bytes and the work of expanding them therefore do not grow with the
// number of sources, and a tile site takes 8 x 18 reals of shared memory
// whatever the link form.  The copy moves 16 bytes at a time wherever a
// slot's run of links is contiguous and aligned (stage 1 of hop_tile), and
// one real at a time elsewhere.
//
// Halo mode (HALO, B1 only) reads the source and the source-parity links
// from arrays extended by one row and one plane on either side in t and z
// (the distributed local step): the z and t neighbours lie at +-1 of the
// centre and never wrap; x and y wrap as in periodic mode.
//
// The launch geometry (D, the source group G, the tile S, the shared-memory
// bytes and the grid) is computed in Python, kernels/geometry.py, which the
// CPU tests check; smem_bytes() below is its formula, used to refuse a
// launch whose shared memory is short.
//
// Summation order: each thread accumulates its directions in the order
// mu = 0..3, forward before backward; the D partial sums are then added in
// order d = 0..D-1.  The order depends on D alone, and the three kernels
// take the same D for the same source count and type, so B2 and B3 agree
// bit for bit, and so does the two-launch Dhat of B1.
#pragma once

#include <cstdint>

#include "wilson_plane.cuh"

namespace wilson {
namespace tile {

// Most threads a block of hop_tile may have (D * G * S).
constexpr int kMaxThreads = 192;
// Blocks per SM the kernels are compiled for, which caps the registers of
// a thread at 65536 / (kMaxThreads * blocks): f32 at 168, f64 at 255.
template <typename R>
struct MinBlocks {
  static constexpr int value = sizeof(R) == 4 ? 2 : 1;
};

// The tile shape of one launch (kernels/geometry.py):
//   G       right-hand sides per group, handled by one block;
//   S       sites of one t-row per tile;
//   groups  ceil(nrhs / G);
//   tiles   tiles per t-row, ceil(Z * Y * Xh / S).
struct Shape {
  int G, S, groups, tiles;
};

// Reals of shared memory per tile site: its 8 links, expanded.
constexpr int kLinkPlanes = 8 * 18;

// Dynamic shared memory of one block.  The D partial sums (D * 24 * G * S
// reals) reuse the link region once the links are read.
inline int64_t smem_bytes(int S, int itemsize) {
  return static_cast<int64_t>(S) * kLinkPlanes * itemsize;
}

// Asynchronous copy of one real from global to shared memory (sm_80+).
template <typename R>
__device__ __forceinline__ void cp_async(R* dst_smem, const R* src) {
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(R))
               : "memory");
}

// Asynchronous copy of 16 bytes, cached in L2 only; both addresses 16-byte
// aligned.
__device__ __forceinline__ void cp_async16(void* dst_smem, const void* src) {
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Neighbour coordinates of output site (t, z, y, xh): the even-odd x shift
// depends on the row parity (t + z + y + t0 + z0) % 2.  Periodic mode wraps
// every neighbour; halo mode (HALO) wraps x and y only, and its z and t
// neighbours are -1 and +1 of the centre (they index halo-extended arrays
// through pointers shifted by one plane and one row).
struct Nbr {
  int xf, xb, yf, yb, zf, zb, tb;
};

template <bool HALO>
__device__ __forceinline__ Nbr neighbours(const Geom& g, int t, int z, int y,
                                          int xh, int out_parity,
                                          int tz_par) {
  Nbr n;
  const int row = (t + z + y + tz_par) & 1;
  n.xf = row == ((out_parity + 1) & 1) ? (xh + 1 == g.Xh ? 0 : xh + 1) : xh;
  n.xb = row == (out_parity & 1) ? (xh == 0 ? g.Xh - 1 : xh - 1) : xh;
  n.yf = y + 1 == g.Y ? 0 : y + 1;
  n.yb = y == 0 ? g.Y - 1 : y - 1;
  if constexpr (HALO) {
    n.zf = z + 1;
    n.zb = z - 1;
    n.tb = t - 1;
  } else {
    n.zf = z + 1 == g.Z ? 0 : z + 1;
    n.zb = z == 0 ? g.Z - 1 : z - 1;
    n.tb = t == 0 ? g.T - 1 : t - 1;
  }
  return n;
}

// Index of link plane 0 of direction mu at (tt, zz, yy, xx) in a planar
// gauge [4][T][Z][GC][Y][Xh].
template <int GC>
__device__ __forceinline__ int64_t link_offset(const Geom& g, int mu, int tt,
                                               int zz, int yy, int xx) {
  return ((static_cast<int64_t>(mu) * g.T + tt) * g.Z + zz) * GC * g.plane +
         static_cast<int64_t>(yy) * g.Xh + xx;
}

// Index of link plane 0 of slot `slot` of output site (t, z, y, xh) with
// neighbours n: an even slot 2*mu is the forward link at the site (in u_out,
// geometry g); an odd slot 2*mu+1 the backward link at the site's -mu
// neighbour (in u_in, geometry gin: g, or g extended by 2 in t and z in halo
// mode, where the centre sits at +1).
template <int GC, bool HALO>
__device__ __forceinline__ int64_t slot_offset(const Geom& g,
                                               const Geom& gin, int slot,
                                               int t, int z, int y, int xh,
                                               const Nbr& n) {
  constexpr int h = HALO ? 1 : 0;
  const int mu = slot >> 1;
  if ((slot & 1) == 0) return link_offset<GC>(g, mu, t, z, y, xh);
  return link_offset<GC>(gin, mu, (mu == 3 ? n.tb : t) + h,
                         (mu == 2 ? n.zb : z) + h, mu == 1 ? n.yb : y,
                         mu == 0 ? n.xb : xh);
}

// Link slot `slot` of tile site s, from its 18 expanded planes (S apart).
template <typename R>
__device__ __forceinline__ void tile_link(const R* lk, int S, int s,
                                          int slot, R u[18]) {
#pragma unroll
  for (int k = 0; k < 18; ++k) u[k] = lk[(slot * 18 + k) * S + s];
}

// Forward and backward term of direction MU for one source: the links come
// from the tile's shared memory (slots 2*MU and 2*MU+1), the source from
// the neighbour sites.
template <int MU, typename R>
__device__ __forceinline__ void tile_dir(const R* lk, int S, int s,
                                         const R* p_fwd, const R* p_bwd,
                                         int64_t plane, R acc[24]) {
  R u[18];
  R p[24];
  R h[12];
  R uh[12];
  tile_link<R>(lk, S, s, 2 * MU, u);
#pragma unroll
  for (int c = 0; c < 24; ++c) p[c] = p_fwd[c * plane];
  project<MU, -1>(p, h);
  su3_mul<false>(u, h, uh);
  recon_acc<MU, -1>(acc, uh);
  tile_link<R>(lk, S, s, 2 * MU + 1, u);
#pragma unroll
  for (int c = 0; c < 24; ++c) p[c] = p_bwd[c * plane];
  project<MU, +1>(p, h);
  su3_mul<true>(u, h, uh);
  recon_acc<MU, +1>(acc, uh);
}

// Link slots whose run over V consecutive sites (V reals = 16 bytes) is
// contiguous: the forward slots 0, 2, 4, 6, the z and t backward slots 5
// and 7 (a run of sites starting at a multiple of V lies in one z plane
// when the plane is a multiple of V), and the y backward slot 3 when the
// x extent Xh is a multiple of V (a run then lies in one y row; else the
// y wrap may split it).  The x backward slot 1 shifts by row parity, site
// by site, and is never a run.  wide_slot(k) is the k-th of them, the y
// slot last.
__device__ __forceinline__ int wide_slot(int k) {
  if (k < 4) return 2 * k;
  if (k == 4) return 5;
  return k == 5 ? 7 : 3;
}

// One hopping block at the tile of sites site0 .. site0+S-1 (flattened
// (z, y, xh) inside t-row t) for the right-hand sides of one group, by the
// whole block (blockDim.x == D * G * S).
//
// src_c / src_tf / src_tb: the source's t-rows t, t+1, t-1, each pointing
// at the element (first source of the group, z=0, c=0, y=0, xh=0); sources
// lie src_stride apart.  In halo mode they are the extended rows t+1, t+2
// and t, each pointing at its plane z=1 (the centre), and u_in is the
// extended [4][T+2][Z+2][GC][Y][Xh] gauge; g is the output's geometry
// either way.  dst (and psi0, if given) point at the same element of the
// output's row t, sources dst_stride apart; the store is dst = acc, or
// dst = psi0 + coeff * acc.  nr is the number of live sources of the group
// (the last group may be short).  out_parity 1 is H_oe (u_out = odd links,
// u_in = even links), 0 is H_eo.  Ends with a block barrier, so the caller
// may publish the tile's stores and reuse shared memory at once.
template <typename R, int GC, int D, bool HALO = false>
__device__ __forceinline__ void hop_tile(
    char* smem, const Geom& g, const Shape& sh, const R* __restrict__ u_out,
    const R* __restrict__ u_in, const R* src_c, const R* src_tf,
    const R* src_tb, int64_t src_stride, R* dst, const R* psi0,
    int64_t dst_stride, int t, int site0, int nr, int out_parity,
    int tz_par, R coeff) {
  const int S = sh.S;
  const int GS = sh.G * S;
  const int tid = threadIdx.x;
  const int64_t plane = g.plane;
  const int row_sites = g.Z * static_cast<int>(plane);
  Geom gin = g;
  if (HALO) {
    gin.T += 2;
    gin.Z += 2;
  }
  R* lk = reinterpret_cast<R*>(smem);
  // Compressed links land at the end of the region and are expanded in
  // place (stage 2).
  R* raw = lk + 8 * (18 - GC) * S;

  // Every stage gives a thread the same tile site s; the D * G threads of
  // a site split its 8 link slots in the copy and expand stages.
  const int s = tid % S;
  const int lane = tid / S;  // d * G + r
  const int lanes = D * sh.G;
  const int site = site0 + s;
  const bool in_row = site < row_sites;
  int xh = 0, y = 0, z = 0;
  Nbr n{};
  if (in_row) {
    xh = site % g.Xh;
    y = (site / g.Xh) % g.Y;
    z = site / static_cast<int>(plane);
    n = neighbours<HALO>(g, t, z, y, xh, out_parity, tz_par);
  }

  // 1. Copy the GC planes of the site's 8 links (forward at the site,
  //    backward at its -mu neighbour) into shared memory, site fastest.
  //    Where runs of V sites are contiguous, 16-byte aligned and the tile a
  //    multiple of V, the threads of a run copy its slots V reals per copy
  //    instruction (see wide_slot); the rest go one real at a time.
  //    Ragged shapes (a plane or a tile that is no multiple of V) take the
  //    second path for every slot.
  constexpr int V = 16 / sizeof(R);
  const bool wide = S % V == 0 && plane % V == 0 &&
      ((reinterpret_cast<uintptr_t>(u_out) |
        reinterpret_cast<uintptr_t>(u_in)) & 15) == 0;
  const bool wide_y = g.Xh % V == 0;
  if (in_row) {
    if (wide) {
      // The V * D * G threads of the V sites of run s / V split its slots
      // (by j = lane * V + s % V); a run's offsets are those of its first
      // site, V sites before the thread's own in every wide slot.
      const int j = lane * V + s % V;
      const int q0 = s - s % V;
      for (int k = j; k < (wide_y ? 7 : 6); k += V * lanes) {
        const int slot = wide_slot(k);
        const R* from = ((slot & 1) ? u_in : u_out) +
                        slot_offset<GC, HALO>(g, gin, slot, t, z, y, xh, n) -
                        s % V;
        R* to = raw + slot * GC * S + q0;
#pragma unroll
        for (int c = 0; c < GC; ++c) cp_async16(to + c * S, from + c * plane);
      }
    }
    // Per real: every slot, or only those that are no run.
    const int singles = wide ? (wide_y ? 1 : 2) : 8;
    for (int k = lane; k < singles; k += lanes) {
      const int slot = wide ? (k == 0 ? 1 : 3) : k;
      const R* from = ((slot & 1) ? u_in : u_out) +
                      slot_offset<GC, HALO>(g, gin, slot, t, z, y, xh, n);
      R* to = raw + slot * GC * S + s;
#pragma unroll
      for (int c = 0; c < GC; ++c) cp_async(to + c * S, from + c * plane);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. Expand compressed links once per tile, in place: slot k's 18
  //    planes, [18k, 18k + 18), end at or before the raw planes of slot
  //    k + 1, which start at 8 * (18 - GC) + GC * (k + 1) >= 18k + 18 for
  //    k <= 7.  So a round of slots may overwrite only raw slots of its own
  //    round or earlier ones, and every thread of a round reads its raw
  //    slot before any thread writes (the barrier; a site with one thread
  //    needs none).
  if (GC != 18) {
    for (int first = 0; first < 8; first += lanes) {
      const int slot = first + lane;
      const bool mine = in_row && slot < 8;
      R u[18];
      if (mine) load_link<R, GC>(raw + slot * GC * S + s, S, u);
      if (lanes > 1) __syncthreads();
      if (mine) {
#pragma unroll
        for (int k = 0; k < 18; ++k) lk[(slot * 18 + k) * S + s] = u[k];
      }
    }
    __syncthreads();
  }

  // 3. Each thread: the terms of its direction group for one (site,
  //    source).
  const int d = lane / sh.G, r = lane % sh.G;
  const bool live = in_row && r < nr;
  R acc[24];
#pragma unroll
  for (int c = 0; c < 24; ++c) acc[c] = R(0);
  const int64_t at = row_offset(g, z, y, xh);
  if (live) {
    const R* pc = src_c + r * src_stride;
    const R* pf = src_tf + r * src_stride;
    const R* pb = src_tb + r * src_stride;
    // Direction groups: D = 2 splits {x, y} | {z, t}.
    if (D == 1 || d == 0) {
      tile_dir<0, R>(lk, S, s, pc + row_offset(g, z, y, n.xf),
                     pc + row_offset(g, z, y, n.xb), plane, acc);
      tile_dir<1, R>(lk, S, s, pc + row_offset(g, z, n.yf, xh),
                     pc + row_offset(g, z, n.yb, xh), plane, acc);
    }
    if (D == 1 || d == 1) {
      tile_dir<2, R>(lk, S, s, pc + row_offset(g, n.zf, y, xh),
                     pc + row_offset(g, n.zb, y, xh), plane, acc);
      tile_dir<3, R>(lk, S, s, pf + at, pb + at, plane, acc);
    }
  }

  // 4. Sum the D partials (through shared memory) and store.
  if constexpr (D == 1) {
    if (live) {
      R* o = dst + r * dst_stride + at;
      const R* q = psi0 != nullptr ? psi0 + r * dst_stride + at : nullptr;
#pragma unroll
      for (int c = 0; c < 24; ++c)
        o[c * plane] = q != nullptr ? q[c * plane] + coeff * acc[c] : acc[c];
    }
  } else {
    __syncthreads();  // every thread has read the links: reuse lk
    R* red = lk;
    const int me = r * S + s;
#pragma unroll
    for (int c = 0; c < 24; ++c) red[(d * 24 + c) * GS + me] = acc[c];
    __syncthreads();
    if (live) {
      constexpr int kPer = 24 / D;
      R* o = dst + r * dst_stride + at;
      const R* q = psi0 != nullptr ? psi0 + r * dst_stride + at : nullptr;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int c = d * kPer + k;
        R v = red[c * GS + me];
#pragma unroll
        for (int dd = 1; dd < D; ++dd) v += red[(dd * 24 + c) * GS + me];
        o[c * plane] = q != nullptr ? q[c * plane] + coeff * v : v;
      }
    }
  }
  __syncthreads();
}

// Call F::template run<R, GC, D>() for the run-time (itemsize, gc, D).
template <typename F, typename R, int GC>
cudaError_t dispatch_d(int dgroups, F& f) {
  switch (dgroups) {
    case 1: return f.template run<R, GC, 1>();
    case 2: return f.template run<R, GC, 2>();
    default: return cudaErrorInvalidValue;
  }
}

template <typename F, typename R>
cudaError_t dispatch_gc(int gc, int dgroups, F& f) {
  switch (gc) {
    case 18: return dispatch_d<F, R, 18>(dgroups, f);
    case 12: return dispatch_d<F, R, 12>(dgroups, f);
    case 8: return dispatch_d<F, R, 8>(dgroups, f);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t dispatch(int itemsize, int gc, int dgroups, F& f) {
  if (itemsize == 4) return dispatch_gc<F, float>(gc, dgroups, f);
  if (itemsize == 8) return dispatch_gc<F, double>(gc, dgroups, f);
  return cudaErrorInvalidValue;
}

// Checks a launch's geometry against what the kernel needs: the thread
// count is D * G * S and at most kMaxThreads, the D partial sums fit the
// link region, and smem covers smem_bytes().
inline cudaError_t check_shape(const Shape& sh, int dgroups, int threads,
                               int itemsize, int64_t smem, int nrhs) {
  if (sh.G < 1 || sh.S < 1 || sh.groups < 1 || sh.tiles < 1)
    return cudaErrorInvalidValue;
  if (threads != dgroups * sh.G * sh.S || threads > kMaxThreads)
    return cudaErrorInvalidValue;
  if (dgroups > 1 && dgroups * 24 * sh.G > kLinkPlanes)
    return cudaErrorInvalidValue;
  if (static_cast<int64_t>(sh.G) * sh.groups < nrhs)
    return cudaErrorInvalidValue;
  if (smem < smem_bytes(sh.S, itemsize)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Lifts `kernel`'s dynamic shared-memory limit to the device's opt-in
// maximum less the kernel's static shared memory (needed above 48 KB).
template <typename K>
cudaError_t lift_smem_limit(K kernel, int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      optin - static_cast<int>(attr.sharedSizeBytes));
}

// Blocks of `kernel` that fit one SM at `threads` threads and `smem` bytes
// of dynamic shared memory.  Lifts the kernel's dynamic shared-memory limit
// first.
template <typename K>
cudaError_t blocks_per_sm(K kernel, int threads, int smem, int device,
                          int* per_sm) {
  cudaError_t err = lift_smem_limit(kernel, device);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       threads, smem);
}

}  // namespace tile
}  // namespace wilson
