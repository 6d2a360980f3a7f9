// Device code that the three kernels share through wilson_site_tile.cuh:
// half-spinor projection, the SU(3) multiply, reconstruction, link
// expansion, the lattice geometry and the device guard of the C entry
// points.
//
// Layouts (planar, identical to the reference package):
//   spinor  [nrhs][T][Z][24][Y][Xh], component c = (spin*3 + color)*2 + reim
//   gauge   [4][T][Z][GC][Y][Xh],    component c = (row*3 + col)*2 + reim
//                                    (GC = 18 full, 12 two_row, 8 minimal)
//
// The arithmetic (operation order included) is the one of the plain version
// in kernels/ref.py, itself the reference's _proj/_su3_mul/_recon_acc.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace wilson {

constexpr int kSpinorComps = 24;

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

// Offset of site (z, y, xh) inside one t-row [Z][24][Y][Xh] of a spinor.
__device__ __forceinline__ int64_t row_offset(const Geom& g, int z, int y,
                                              int xh) {
  return static_cast<int64_t>(z) * kSpinorComps * g.plane +
         static_cast<int64_t>(y) * g.Xh + xh;
}

// Elements of one t-row of one right-hand side: Z * 24 * Y * Xh.
__device__ __forceinline__ int64_t row_elems(const Geom& g) {
  return static_cast<int64_t>(g.Z) * kSpinorComps * g.plane;
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

}  // namespace wilson
