// Device code shared by the hop-block kernel (wilson_hop.cu) and the fused
// Dhat kernel (wilson_dhat_fused.cu): half-spinor projection, the SU(3)
// multiply, reconstruction, in-register link expansion, and one hopping
// block evaluated at one site for a block of right-hand sides.
//
// Layouts (planar, identical to the reference package):
//   spinor  [nrhs][T][Z][24][Y][Xh], component c = (spin*3 + color)*2 + reim
//   gauge   [4][T][Z][GC][Y][Xh],    component c = (row*3 + col)*2 + reim
//                                    (GC = 18 full, 12 two_row, 8 minimal)
// One thread owns one output site (t, z, y, xh).  Consecutive threads take
// consecutive xh, so every component-plane load of a warp is one contiguous
// run of addresses.
//
// The arithmetic (operation order included) is the one of the plain version
// in kernels/ref.py, itself the reference's _proj/_su3_mul/_recon_acc.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace wilson {

constexpr int kSpinorComps = 24;
constexpr int kBlockThreads = 128;
// Blocks per SM the kernels are compiled for: caps registers at 128 per
// thread (65536 / (128 * 4)), so a memory-bound hop keeps 16 warps per SM.
constexpr int kMinBlocksPerSM = 4;

struct Geom {
  int T, Z, Y, Xh;
  int64_t plane;  // Y * Xh
  int64_t sites;  // T * Z * Y * Xh (sites of one parity)
};

inline Geom make_geom(int T, int Z, int Y, int Xh) {
  Geom g;
  g.T = T;
  g.Z = Z;
  g.Y = Y;
  g.Xh = Xh;
  g.plane = static_cast<int64_t>(Y) * Xh;
  g.sites = static_cast<int64_t>(T) * Z * g.plane;
  return g;
}

template <int S, typename R>
__device__ __forceinline__ R sg(R v) {
  return S > 0 ? v : -v;
}

// Rounded arithmetic that the compiler never contracts into an FMA.  The
// link expansion below uses it so that its rounding matches the plain
// PyTorch version (one rounding per elementwise op) exactly: minimal links
// divide by D = |a2|^2 + |a3|^2, which would amplify a one-ulp difference of
// a contracted product when D is small.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// (ar + i ai)(br + i bi) = (ar br - ai bi) + i (ar bi + ai br)
template <typename R>
__device__ __forceinline__ void cmul_rn(R ar, R ai, R br, R bi, R* re, R* im) {
  *re = sub_rn(mul_rn(ar, br), mul_rn(ai, bi));
  *im = add_rn(mul_rn(ar, bi), mul_rn(ai, br));
}

// Load GC planes of one link (stride `plane` between planes) and expand them
// to the 18 components of the full SU(3) matrix (the operations and their
// order are those of layout.expand_links_planes).
template <typename R, int GC>
__device__ __forceinline__ void load_link(const R* __restrict__ g,
                                          int64_t plane, R u[18]) {
  if constexpr (GC == 18) {
#pragma unroll
    for (int i = 0; i < 18; ++i) u[i] = g[i * plane];
  } else {
    R a1r, a1i, a2r, a2i, a3r, a3i, b1r, b1i, b2r, b2i, b3r, b3i, c1r, c1i;
    R t1r, t1i, t2r, t2i;
    if constexpr (GC == 12) {
      a1r = g[0];
      a1i = g[plane];
      a2r = g[2 * plane];
      a2i = g[3 * plane];
      a3r = g[4 * plane];
      a3i = g[5 * plane];
      b1r = g[6 * plane];
      b1i = g[7 * plane];
      b2r = g[8 * plane];
      b2i = g[9 * plane];
      b3r = g[10 * plane];
      b3i = g[11 * plane];
      // c1 = conj(a2 b3 - a3 b2)
      cmul_rn(a2r, a2i, b3r, b3i, &t1r, &t1i);
      cmul_rn(a3r, a3i, b2r, b2i, &t2r, &t2i);
      c1r = sub_rn(t1r, t2r);
      c1i = sub_rn(t2i, t1i);
    } else {
      static_assert(GC == 8, "gauge planes must be 18, 12 or 8");
      a2r = g[0];
      a2i = g[plane];
      a3r = g[2 * plane];
      a3i = g[3 * plane];
      b1r = g[4 * plane];
      b1i = g[5 * plane];
      const R tha = g[6 * plane], thc = g[7 * plane];
      const R d = add_rn(add_rn(add_rn(mul_rn(a2r, a2r), mul_rn(a2i, a2i)),
                                mul_rn(a3r, a3r)),
                         mul_rn(a3i, a3i));
      const R a1m = sqrt(fmax(sub_rn(R(1), d), R(0)));
      a1r = mul_rn(a1m, cos(tha));
      a1i = mul_rn(a1m, sin(tha));
      const R c1m = sqrt(fmax(
          sub_rn(d, add_rn(mul_rn(b1r, b1r), mul_rn(b1i, b1i))), R(0)));
      c1r = mul_rn(c1m, cos(thc));
      c1i = mul_rn(c1m, sin(thc));
      const R dinv = div_rn(R(1), fmax(d, R(1e-30)));
      // s = -conj(a1) b1
      R sr, si;
      cmul_rn(a1r, -a1i, b1r, b1i, &sr, &si);
      sr = -sr;
      si = -si;
      // b2 = (a2 s - conj(a3) conj(c1)) / D
      cmul_rn(a2r, a2i, sr, si, &t1r, &t1i);
      cmul_rn(a3r, -a3i, c1r, -c1i, &t2r, &t2i);
      b2r = mul_rn(sub_rn(t1r, t2r), dinv);
      b2i = mul_rn(sub_rn(t1i, t2i), dinv);
      // b3 = (a3 s + conj(a2) conj(c1)) / D
      cmul_rn(a3r, a3i, sr, si, &t1r, &t1i);
      cmul_rn(a2r, -a2i, c1r, -c1i, &t2r, &t2i);
      b3r = mul_rn(add_rn(t1r, t2r), dinv);
      b3i = mul_rn(add_rn(t1i, t2i), dinv);
    }
    // c2 = conj(a3 b1 - a1 b3), c3 = conj(a1 b2 - a2 b1)
    cmul_rn(a3r, a3i, b1r, b1i, &t1r, &t1i);
    cmul_rn(a1r, a1i, b3r, b3i, &t2r, &t2i);
    const R c2r = sub_rn(t1r, t2r), c2i = sub_rn(t2i, t1i);
    cmul_rn(a1r, a1i, b2r, b2i, &t1r, &t1i);
    cmul_rn(a2r, a2i, b1r, b1i, &t2r, &t2i);
    const R c3r = sub_rn(t1r, t2r), c3i = sub_rn(t2i, t1i);
    u[0] = a1r; u[1] = a1i; u[2] = a2r; u[3] = a2i; u[4] = a3r; u[5] = a3i;
    u[6] = b1r; u[7] = b1i; u[8] = b2r; u[9] = b2i; u[10] = b3r; u[11] = b3i;
    u[12] = c1r; u[13] = c1i; u[14] = c2r; u[15] = c2i; u[16] = c3r;
    u[17] = c3i;
  }
}

// Half-spinor projection of (1 + S*gamma_MU) p; h[(sp*3 + a)*2 + reim].
template <int MU, int S, typename R>
__device__ __forceinline__ void project(const R p[24], R h[12]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const R p0r = p[a * 2], p0i = p[a * 2 + 1];
    const R p1r = p[(3 + a) * 2], p1i = p[(3 + a) * 2 + 1];
    const R p2r = p[(6 + a) * 2], p2i = p[(6 + a) * 2 + 1];
    const R p3r = p[(9 + a) * 2], p3i = p[(9 + a) * 2 + 1];
    R h0r, h0i, h1r, h1i;
    if constexpr (MU == 0) {  // h0 = p0 + s*i*p3, h1 = p1 + s*i*p2
      h0r = p0r - sg<S>(p3i);
      h0i = p0i + sg<S>(p3r);
      h1r = p1r - sg<S>(p2i);
      h1i = p1i + sg<S>(p2r);
    } else if constexpr (MU == 1) {  // h0 = p0 - s*p3, h1 = p1 + s*p2
      h0r = p0r - sg<S>(p3r);
      h0i = p0i - sg<S>(p3i);
      h1r = p1r + sg<S>(p2r);
      h1i = p1i + sg<S>(p2i);
    } else if constexpr (MU == 2) {  // h0 = p0 + s*i*p2, h1 = p1 - s*i*p3
      h0r = p0r - sg<S>(p2i);
      h0i = p0i + sg<S>(p2r);
      h1r = p1r + sg<S>(p3i);
      h1i = p1i - sg<S>(p3r);
    } else {  // h0 = p0 + s*p2, h1 = p1 + s*p3
      h0r = p0r + sg<S>(p2r);
      h0i = p0i + sg<S>(p2i);
      h1r = p1r + sg<S>(p3r);
      h1i = p1i + sg<S>(p3i);
    }
    h[a * 2] = h0r;
    h[a * 2 + 1] = h0i;
    h[(3 + a) * 2] = h1r;
    h[(3 + a) * 2 + 1] = h1i;
  }
}

// uh[sp][a] = sum_b U[a][b] h[sp][b], or U^dag for DAG.
template <bool DAG, typename R>
__device__ __forceinline__ void su3_mul(const R u[18], const R h[12],
                                        R uh[12]) {
#pragma unroll
  for (int sp = 0; sp < 2; ++sp) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      R rr = R(0), ri = R(0);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int k = DAG ? (b * 3 + a) * 2 : (a * 3 + b) * 2;
        const R ur = u[k], ui = u[k + 1];
        const R hr = h[(sp * 3 + b) * 2], hi = h[(sp * 3 + b) * 2 + 1];
        if (DAG) {  // conj(u) h
          rr += ur * hr + ui * hi;
          ri += ur * hi - ui * hr;
        } else {
          rr += ur * hr - ui * hi;
          ri += ur * hi + ui * hr;
        }
      }
      uh[(sp * 3 + a) * 2] = rr;
      uh[(sp * 3 + a) * 2 + 1] = ri;
    }
  }
}

// Rebuild the 4-spinor of (1 + S*gamma_MU) from uh and add it to acc.
template <int MU, int S, typename R>
__device__ __forceinline__ void recon_acc(R acc[24], const R uh[12]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const R h0r = uh[a * 2], h0i = uh[a * 2 + 1];
    const R h1r = uh[(3 + a) * 2], h1i = uh[(3 + a) * 2 + 1];
    R* s0 = acc + a * 2;
    R* s1 = acc + (3 + a) * 2;
    R* s2 = acc + (6 + a) * 2;
    R* s3 = acc + (9 + a) * 2;
    s0[0] += h0r;
    s0[1] += h0i;
    s1[0] += h1r;
    s1[1] += h1i;
    if constexpr (MU == 0) {  // r2 = -s*i*h1, r3 = -s*i*h0
      s2[0] += sg<S>(h1i);
      s2[1] += -sg<S>(h1r);
      s3[0] += sg<S>(h0i);
      s3[1] += -sg<S>(h0r);
    } else if constexpr (MU == 1) {  // r2 = s*h1, r3 = -s*h0
      s2[0] += sg<S>(h1r);
      s2[1] += sg<S>(h1i);
      s3[0] += -sg<S>(h0r);
      s3[1] += -sg<S>(h0i);
    } else if constexpr (MU == 2) {  // r2 = -s*i*h0, r3 = s*i*h1
      s2[0] += sg<S>(h0i);
      s2[1] += -sg<S>(h0r);
      s3[0] += -sg<S>(h1i);
      s3[1] += sg<S>(h1r);
    } else {  // r2 = s*h0, r3 = s*h1
      s2[0] += sg<S>(h0r);
      s2[1] += sg<S>(h0i);
      s3[0] += sg<S>(h1r);
      s3[1] += sg<S>(h1i);
    }
  }
}

// Forward and backward term of direction MU for a block of up to NB
// right-hand sides.  Each link is loaded and expanded once and serves every
// right-hand side of the block.
template <int MU, typename R, int GC, int NB>
__device__ __forceinline__ void hop_dir(
    const R* __restrict__ u_fwd, const R* __restrict__ u_bwd,
    const R* p_fwd, const R* p_bwd, int64_t plane, int64_t rhs_stride,
    int nb, R acc[NB][24]) {
  R u[18];
  R p[24];
  R h[12];
  R uh[12];
  // Forward: (1 - g_mu) U_mu(x) psi(x + mu).
  load_link<R, GC>(u_fwd, plane, u);
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    if (r < nb) {
#pragma unroll
      for (int c = 0; c < 24; ++c) p[c] = p_fwd[r * rhs_stride + c * plane];
      project<MU, -1>(p, h);
      su3_mul<false>(u, h, uh);
      recon_acc<MU, -1>(acc[r], uh);
    }
  }
  // Backward: (1 + g_mu) U_mu^dag(x - mu) psi(x - mu).
  load_link<R, GC>(u_bwd, plane, u);
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    if (r < nb) {
#pragma unroll
      for (int c = 0; c < 24; ++c) p[c] = p_bwd[r * rhs_stride + c * plane];
      project<MU, +1>(p, h);
      su3_mul<true>(u, h, uh);
      recon_acc<MU, +1>(acc[r], uh);
    }
  }
}

// One periodic hopping block at output site `idx` for right-hand sides
// r0 .. r0+nb-1 (nb <= NB): acc[r] = sum over the 8 directions.
// out_parity 1 is H_oe (u_out = odd links, u_in = even links), 0 is H_eo.
// tz_par is (t0 + z0) % 2 of the lattice origin.
template <typename R, int GC, int NB>
__device__ __forceinline__ void hop_site(
    const R* __restrict__ u_out, const R* __restrict__ u_in, const R* src,
    const Geom& g, int64_t idx, int nb, int out_parity, int tz_par,
    R acc[NB][24]) {
  const int xh = static_cast<int>(idx % g.Xh);
  const int y = static_cast<int>((idx / g.Xh) % g.Y);
  const int z = static_cast<int>((idx / g.plane) % g.Z);
  const int t = static_cast<int>(idx / (g.plane * g.Z));
  // Row parity (t+z+y) % 2 decides the even-odd x shift (the paper's sel).
  const int row = (t + z + y + tz_par) & 1;
  const int xf = row == ((out_parity + 1) & 1) ? (xh + 1 == g.Xh ? 0 : xh + 1)
                                               : xh;
  const int xb = row == (out_parity & 1) ? (xh == 0 ? g.Xh - 1 : xh - 1) : xh;
  const int yf = y + 1 == g.Y ? 0 : y + 1, yb = y == 0 ? g.Y - 1 : y - 1;
  const int zf = z + 1 == g.Z ? 0 : z + 1, zb = z == 0 ? g.Z - 1 : z - 1;
  const int tf = t + 1 == g.T ? 0 : t + 1, tb = t == 0 ? g.T - 1 : t - 1;

  const int64_t plane = g.plane;
  const int64_t rhs_stride = g.sites * kSpinorComps;
  auto soff = [&](int tt, int zz, int yy, int xx) -> int64_t {
    return (static_cast<int64_t>(tt) * g.Z + zz) * kSpinorComps * plane +
           static_cast<int64_t>(yy) * g.Xh + xx;
  };
  auto goff = [&](int mu, int tt, int zz, int yy, int xx) -> int64_t {
    return ((static_cast<int64_t>(mu) * g.T + tt) * g.Z + zz) * GC * plane +
           static_cast<int64_t>(yy) * g.Xh + xx;
  };

#pragma unroll
  for (int r = 0; r < NB; ++r) {
#pragma unroll
    for (int c = 0; c < 24; ++c) acc[r][c] = R(0);
  }
  hop_dir<0, R, GC, NB>(u_out + goff(0, t, z, y, xh), u_in + goff(0, t, z, y, xb),
                        src + soff(t, z, y, xf), src + soff(t, z, y, xb),
                        plane, rhs_stride, nb, acc);
  hop_dir<1, R, GC, NB>(u_out + goff(1, t, z, y, xh), u_in + goff(1, t, z, yb, xh),
                        src + soff(t, z, yf, xh), src + soff(t, z, yb, xh),
                        plane, rhs_stride, nb, acc);
  hop_dir<2, R, GC, NB>(u_out + goff(2, t, z, y, xh), u_in + goff(2, t, zb, y, xh),
                        src + soff(t, zf, y, xh), src + soff(t, zb, y, xh),
                        plane, rhs_stride, nb, acc);
  hop_dir<3, R, GC, NB>(u_out + goff(3, t, z, y, xh), u_in + goff(3, tb, z, y, xh),
                        src + soff(tf, z, y, xh), src + soff(tb, z, y, xh),
                        plane, rhs_stride, nb, acc);
}

// Hop at site `idx` for every right-hand side, in blocks of NB, and store
// out = acc, or out = psi0 + coeff * acc when psi0 is given.
template <typename R, int GC, int NB>
__device__ __forceinline__ void hop_site_store(
    const R* __restrict__ u_out, const R* __restrict__ u_in, const R* src,
    const R* psi0, R* out, const Geom& g, int nrhs, int64_t idx,
    int out_parity, int tz_par, R coeff) {
  const int64_t rhs_stride = g.sites * kSpinorComps;
  const int64_t xh = idx % g.Xh;
  const int64_t y = (idx / g.Xh) % g.Y;
  const int64_t tz = idx / g.plane;  // t * Z + z
  const int64_t site = tz * kSpinorComps * g.plane + y * g.Xh + xh;
  for (int r0 = 0; r0 < nrhs; r0 += NB) {
    const int nb = nrhs - r0 < NB ? nrhs - r0 : NB;
    R acc[NB][24];
    hop_site<R, GC, NB>(u_out, u_in, src + r0 * rhs_stride, g, idx, nb,
                        out_parity, tz_par, acc);
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      if (r < nb) {
        const int64_t base = (r0 + r) * rhs_stride + site;
#pragma unroll
        for (int c = 0; c < 24; ++c) {
          const int64_t o = base + c * g.plane;
          out[o] = psi0 != nullptr ? psi0[o] + coeff * acc[r][c] : acc[r][c];
        }
      }
    }
  }
}

// Dispatch helper: call F::template run<R, GC, NB>() for the run-time
// (itemsize, gc, nrhs).  NB is the right-hand-side block a thread keeps in
// registers: 1, 2, or 4 (nrhs >= 3 runs in blocks of 4).
template <typename F, typename R, int GC>
cudaError_t dispatch_nb(int nrhs, F& f) {
  if (nrhs == 1) return f.template run<R, GC, 1>();
  if (nrhs == 2) return f.template run<R, GC, 2>();
  return f.template run<R, GC, 4>();
}

template <typename F, typename R>
cudaError_t dispatch_gc(int gc, int nrhs, F& f) {
  switch (gc) {
    case 18: return dispatch_nb<F, R, 18>(nrhs, f);
    case 12: return dispatch_nb<F, R, 12>(nrhs, f);
    case 8: return dispatch_nb<F, R, 8>(nrhs, f);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t dispatch(int itemsize, int gc, int nrhs, F& f) {
  if (nrhs < 1) return cudaErrorInvalidValue;
  if (itemsize == 4) return dispatch_gc<F, float>(gc, nrhs, f);
  if (itemsize == 8) return dispatch_gc<F, double>(gc, nrhs, f);
  return cudaErrorInvalidValue;
}

// Makes `device` the calling thread's current device for one launch and
// restores the previous one afterwards.  The caller's current device is
// usually the tensor's already, so the common case is one cudaGetDevice.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};

// A positive integer fact of one device that never changes while the
// process runs (an SM count, a kernel's occupancy), looked up once per
// device: `cache` is a zero-initialised static array of kMaxDevices.
constexpr int kMaxDevices = 64;

template <typename Query>
cudaError_t cached_per_device(std::atomic<int>* cache, int device, int* value,
                              Query query) {
  const bool slot = device >= 0 && device < kMaxDevices;
  if (slot) {
    *value = cache[device].load(std::memory_order_relaxed);
    if (*value > 0) return cudaSuccess;
  }
  cudaError_t err = query(value);
  if (err == cudaSuccess && slot && *value > 0)
    cache[device].store(*value, std::memory_order_relaxed);
  return err;
}

}  // namespace wilson
