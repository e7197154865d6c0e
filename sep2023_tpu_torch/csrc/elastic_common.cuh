// Arithmetic shared by the forward kernels (elastic_fwd.cu, acoustic_fwd.cu)
// and the backward kernels (elastic_bwd.cu, acoustic_bwd.cu): the O(4)
// stencils and their transposes, the CPML derivative and its adjoint, the
// interior increments of the elastic stress and velocity half-steps (the
// acoustic ones are in acoustic_common.cuh), the source sample and the
// boundary-strip layout.
//
// Reconstruction.  The backward rebuilds the forward's state one step back
// by subtracting, in the interior, the increment the forward added.  Both
// kernels compute that increment with the functions below, so with equal
// inputs they give the same float.  Every operation here uses an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc
// never contracts into an FMA: the rounding of this shared code is pinned by
// the source, whatever the build flags, and the rest of both kernels (CPML
// memory in the PML, the adjoint arithmetic) stays free to use FMAs.  That
// is why the build does not pass --fmad=false.
//
// Edge rule: a stencil neighbour outside the grid reads as 0, the
// zero-padded edge of ops/fd.py.  The transposed stencils follow the same
// rule, so each is the exact adjoint of its forward stencil on the grid.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace elastic {

constexpr float kC1 = static_cast<float>(9.0 / 8.0);
constexpr float kC2 = static_cast<float>(1.0 / 24.0);

constexpr int kBlockX = 32;
constexpr int kBlockZ = 8;
constexpr int kNumFields = 5;

// Field order of every (5, S, nz, nx) buffer and of the strips: Fields.
enum Field { F_VZ = 0, F_VX, F_SZZ, F_SXX, F_SXZ };

// Material planes (5, nz, nx): lam, lam + 2 mu, harmonic mu, two buoyancies.
enum Mat { LAM = 0, LP2M, AVE_MU, BYC_A, BYC_B };

// The ett channel: vx[z,x] - vx[z,x-1], vz[z,x] - vz[z-1,x] (neither divided
// by the spacing), or the weighted fiber strain w0 exx + w1 exz + w2 ezz.
enum EttMode { ETT_EXX = 0, ETT_EZZ, ETT_WEIGHTED };

// Profile rows: prof_z (6, nz) and prof_x (6, nx), as cpml.CpmlScaled.
enum Prof { IK = 0, A, B, IK_H, A_H, B_H };

__device__ __forceinline__ size_t plane_offset(int k, int s, int S, int nz,
                                               int nx) {
  return (static_cast<size_t>(k) * S + s) * static_cast<size_t>(nz) * nx;
}

__device__ __forceinline__ float at(const float* f, int z, int x, int nz,
                                    int nx) {
  return (z >= 0 && z < nz && x >= 0 && x < nx)
             ? f[static_cast<size_t>(z) * nx + x] : 0.0f;
}

// c1 (a - b) - c2 (c - d), rounded step by step.
__device__ __forceinline__ float stencil(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(kC1, __fsub_rn(a, b)),
                   __fmul_rn(kC2, __fsub_rn(c, d)));
}

// dminus[i] = c1 (f[i] - f[i-1]) - c2 (f[i+1] - f[i-2])
// dplus[i]  = c1 (f[i+1] - f[i]) - c2 (f[i+2] - f[i-1])
__device__ __forceinline__ float dz_minus(const float* f, int z, int x,
                                          int nz, int nx) {
  return stencil(at(f, z, x, nz, nx), at(f, z - 1, x, nz, nx),
                 at(f, z + 1, x, nz, nx), at(f, z - 2, x, nz, nx));
}

__device__ __forceinline__ float dz_plus(const float* f, int z, int x,
                                         int nz, int nx) {
  return stencil(at(f, z + 1, x, nz, nx), at(f, z, x, nz, nx),
                 at(f, z + 2, x, nz, nx), at(f, z - 1, x, nz, nx));
}

__device__ __forceinline__ float dx_minus(const float* f, int z, int x,
                                          int nz, int nx) {
  return stencil(at(f, z, x, nz, nx), at(f, z, x - 1, nz, nx),
                 at(f, z, x + 1, nz, nx), at(f, z, x - 2, nz, nx));
}

__device__ __forceinline__ float dx_plus(const float* f, int z, int x,
                                         int nz, int nx) {
  return stencil(at(f, z, x + 1, nz, nx), at(f, z, x, nz, nx),
                 at(f, z, x + 2, nz, nx), at(f, z, x - 1, nz, nx));
}

// CPML derivative of the forward: psi <- b psi + a d, returns d ik + psi.
// In the interior a = 0 and psi stays 0, so it returns d ik rounded once:
// the value the reverse step computes as __fmul_rn(d, ik).
__device__ __forceinline__ float cpml_deriv(float d, float ik, float a,
                                            float b, float* psi) {
  const float p = __fadd_rn(__fmul_rn(b, *psi), __fmul_rn(a, d));
  *psi = p;
  return __fadd_rn(__fmul_rn(d, ik), p);
}

struct StressInc {
  float zz, xx, xz;
};

// The stress half-step's increments from the four velocity derivatives:
// (lp2m e_zz + lam e_xx) dt, (lam e_zz + lp2m e_xx) dt, mu (e_xz + e_zx) dt.
__device__ __forceinline__ StressInc stress_increment(float e_zz, float e_xx,
                                                      float e_xz, float e_zx,
                                                      const float* mats,
                                                      size_t plane_n,
                                                      size_t c, float dt) {
  const float lam = mats[LAM * plane_n + c];
  const float lp2m = mats[LP2M * plane_n + c];
  const float mu = mats[AVE_MU * plane_n + c];
  StressInc inc;
  inc.zz = __fmul_rn(__fadd_rn(__fmul_rn(lp2m, e_zz), __fmul_rn(lam, e_xx)),
                     dt);
  inc.xx = __fmul_rn(__fadd_rn(__fmul_rn(lam, e_zz), __fmul_rn(lp2m, e_xx)),
                     dt);
  inc.xz = __fmul_rn(__fmul_rn(mu, __fadd_rn(e_xz, e_zx)), dt);
  return inc;
}

// The velocity half-step's increment of one component: (e_a + e_b) byc dt.
__device__ __forceinline__ float velocity_increment(float e_a, float e_b,
                                                    float byc, float dt) {
  return __fmul_rn(__fmul_rn(__fadd_rn(e_a, e_b), byc), dt);
}

// The source sample of shot s at step it: src_scale dt stf[s, it].
__device__ __forceinline__ float source_amp(const float* stf, int s, int it,
                                            int nt, float src_amp) {
  return __fmul_rn(src_amp, stf[static_cast<size_t>(s) * nt + it]);
}

// Boundary strips (propagator._strip_bounds / _extract_strips): per field,
// top (L, nx), bottom (L, nx), left (nz, L) and right (nz, L), row-major,
// in that order; n = 2 L (nx + nz) floats.  The wrapper checks that the
// strips lie inside the grid and do not overlap (check_strip_grid).
struct StripGeom {
  int L, z0, z1, x0, x1;
  int n;
};

__host__ __device__ inline StripGeom strip_geom(int nz, int nx, int npml,
                                                int L) {
  return StripGeom{L, npml - 2, nz - npml - 3, npml - 2, nx - npml - 3,
                   2 * L * (nx + nz)};
}

// The strip slots of cell (z, x): none, one, or two at a corner, where a
// row strip and a column strip meet.  Returns their number.
__device__ __forceinline__ int strip_slots(const StripGeom& g, int z, int x,
                                           int nz, int nx, int* slot) {
  int n = 0;
  if (z >= g.z0 && z < g.z0 + g.L) {
    slot[n++] = (z - g.z0) * nx + x;
  } else if (z >= g.z1 && z < g.z1 + g.L) {
    slot[n++] = (g.L + z - g.z1) * nx + x;
  }
  if (x >= g.x0 && x < g.x0 + g.L) {
    slot[n++] = 2 * g.L * nx + z * g.L + (x - g.x0);
  } else if (x >= g.x1 && x < g.x1 + g.L) {
    slot[n++] = 2 * g.L * nx + (nz + z) * g.L + (x - g.x1);
  }
  return n;
}

// Strips of one shot and step: (S, nt-1, n_fields, n) -> the n_fields x n
// block (5 elastic fields, 3 acoustic ones).
__device__ __forceinline__ size_t strip_offset(const StripGeom& g, int s,
                                               int it, int nt,
                                               int n_fields = kNumFields) {
  return (static_cast<size_t>(s) * (nt - 1) + it) * n_fields *
         static_cast<size_t>(g.n);
}

// Transposed stencils in gather form: the cotangent of f[i] from the
// cotangents g of dminus / dplus at every i.
//   dminus^T g[i] = c1 (g[i] - g[i+1]) - c2 (g[i-1] - g[i+2])
//   dplus^T g[i]  = c1 (g[i-1] - g[i]) - c2 (g[i-2] - g[i+1])
__device__ __forceinline__ float dz_minus_t(const float* g, int z, int x,
                                            int nz, int nx) {
  return stencil(at(g, z, x, nz, nx), at(g, z + 1, x, nz, nx),
                 at(g, z - 1, x, nz, nx), at(g, z + 2, x, nz, nx));
}

__device__ __forceinline__ float dz_plus_t(const float* g, int z, int x,
                                           int nz, int nx) {
  return stencil(at(g, z - 1, x, nz, nx), at(g, z, x, nz, nx),
                 at(g, z - 2, x, nz, nx), at(g, z + 1, x, nz, nx));
}

__device__ __forceinline__ float dx_minus_t(const float* g, int z, int x,
                                            int nz, int nx) {
  return stencil(at(g, z, x, nz, nx), at(g, z, x + 1, nz, nx),
                 at(g, z, x - 1, nz, nx), at(g, z, x + 2, nz, nx));
}

__device__ __forceinline__ float dx_plus_t(const float* g, int z, int x,
                                           int nz, int nx) {
  return stencil(at(g, z, x - 1, nz, nx), at(g, z, x, nz, nx),
                 at(g, z, x - 2, nz, nx), at(g, z, x + 1, nz, nx));
}

// Adjoint of one CPML derivative e = d ik + p', p' = b psi + a d, at zero
// primal psi: from the cotangent ge of e and the carried cotangent of p'
// (updated in place to that of psi), the cotangent of the raw difference d.
__device__ __forceinline__ float cpml_deriv_adj(float ge, float ik, float a,
                                                float b, float* psi_bar) {
  const float q = *psi_bar + ge;
  *psi_bar = b * q;
  return ge * ik + a * q;
}

__device__ __forceinline__ bool in_update_mask(int z, int x, int nz,
                                               int nx) {
  return z >= 2 && z <= nz - 3 && x >= 2 && x <= nx - 3;
}

}  // namespace elastic
