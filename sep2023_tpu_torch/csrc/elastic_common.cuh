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
                                                      float lam, float lp2m,
                                                      float mu, float dt) {
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

// ---------------------------------------------------------------------------
// Tiles in shared memory, for the fused step kernels of elastic_fwd.cu and
// elastic_bwd.cu.  A block owns a kTileZ x kTileX tile of one shot and runs
// kTileThreads threads.
// ---------------------------------------------------------------------------

constexpr int kTileZ = 16;
constexpr int kTileX = 32;
constexpr int kTileThreads = 256;
// The tile with a 4-cell halo (what a step reads at neighbours) and with a
// 2-cell halo (what the first phase of a step computes for the second), and
// their cells.
constexpr int kHalo4Z = kTileZ + 8, kHalo4X = kTileX + 8;
constexpr int kHalo2Z = kTileZ + 4, kHalo2X = kTileX + 4;
constexpr int kH4 = kHalo4Z * kHalo4X, kH2 = kHalo2Z * kHalo2X;
constexpr int kT = kTileZ * kTileX;
// Shared memory of the fused step kernels in floats: every value a step
// reads is copied in at the top of the block (the layouts are in
// elastic_fwd.cu and elastic_bwd.cu).  The forward: vz, vx with the 4-cell
// halo; the stresses, 3 material planes and 4 CPML memories with the 2-cell
// halo; 2 buoyancies and 4 memories on the tile.  The backward: the
// stresses and D1..D4 with the 4-cell halo; the cotangents of vz, vx, the
// velocities, 2 buoyancies and 4 memories with the 2-cell halo; the
// stresses' cotangents, 3 material planes, 4 memories and 5 gradients on
// the tile; and a point receivers' cotangent sum and its place a thread.
constexpr int kFwdShared = 2 * kH4 + 10 * kH2 + 6 * kT;
constexpr int kBwdShared = 7 * kH4 + 10 * kH2 + 15 * kT + 2 * kTileThreads;
// The forward's is static (48 KiB at most a block); the backward's is set
// per launch as dynamic shared memory, two blocks of it an SM (228 KiB, 1
// KiB of it reserved a block).
static_assert(kFwdShared * sizeof(float) <= 48 * 1024,
              "static shared memory of fwd_step_kernel");
static_assert(2 * (kBwdShared * sizeof(float) + 1024) <= 228 * 1024,
              "two blocks of bwd_step_kernel an SM");

// What elastic_forward, elastic_backward and acoustic_forward return, before
// any launch, for a receiver table built for other tiles than kTileZ x
// kTileX (elastic_error_string names it).
constexpr int kErrTileMismatch = -1;

// The stencils and transposes above on a tile held in shared memory with
// row pitch W, at flat index i: the same operands in the same order, so the
// same float.  A cell of the tile that lies outside the grid holds 0, the
// edge rule of at().
template <int W>
__device__ __forceinline__ float tile_dz_minus(const float* t, int i) {
  return stencil(t[i], t[i - W], t[i + W], t[i - 2 * W]);
}

template <int W>
__device__ __forceinline__ float tile_dz_plus(const float* t, int i) {
  return stencil(t[i + W], t[i], t[i + 2 * W], t[i - W]);
}

template <int W>
__device__ __forceinline__ float tile_dx_minus(const float* t, int i) {
  return stencil(t[i], t[i - 1], t[i + 1], t[i - 2]);
}

template <int W>
__device__ __forceinline__ float tile_dx_plus(const float* t, int i) {
  return stencil(t[i + 1], t[i], t[i + 2], t[i - 1]);
}

template <int W>
__device__ __forceinline__ float tile_dz_minus_t(const float* g, int i) {
  return stencil(g[i], g[i + W], g[i - W], g[i + 2 * W]);
}

template <int W>
__device__ __forceinline__ float tile_dz_plus_t(const float* g, int i) {
  return stencil(g[i - W], g[i], g[i - 2 * W], g[i + W]);
}

template <int W>
__device__ __forceinline__ float tile_dx_minus_t(const float* g, int i) {
  return stencil(g[i], g[i + 1], g[i - 1], g[i + 2]);
}

template <int W>
__device__ __forceinline__ float tile_dx_plus_t(const float* g, int i) {
  return stencil(g[i - 1], g[i], g[i - 2], g[i + 1]);
}

// One f32 from device memory into shared memory with cp.async; when `on`
// is false nothing is read (src-size 0) and the word is filled with 0.
// `src` must be a valid address either way.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool on) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(on ? 4 : 0) : "memory");
}

// Close this thread's group of cp.async copies issued since the last one.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight; a
// __syncthreads() after it makes every thread's copies visible.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The CPML band of one axis: the indices where the profile's a or a_h is
// not 0, [0, lo) and [hi, n).  Inside [lo, hi) a = 0 exactly, so the memory
// psi <- b psi + a d stays 0 there and the derivative is d ik.  The
// memories live in band storage: index i of the band is row (column) i for
// i < lo and i - (hi - lo) for i >= hi.  ops/cuda_engine.cpml_bands takes
// lo and hi from the profiles the kernels read.
struct Band {
  int lo, hi;
};

__device__ __forceinline__ bool in_band(const Band& b, int i) {
  return i < b.lo || i >= b.hi;
}

__device__ __forceinline__ int band_index(const Band& b, int i) {
  return i < b.lo ? i : i - (b.hi - b.lo);
}

__host__ __device__ inline int band_size(const Band& b, int n) {
  return n - (b.hi - b.lo);
}

// cpml_deriv with the memory read from one buffer and written to another
// (the fused forward keeps the stress phase's memories twice): the same
// operations in the same order.
__device__ __forceinline__ float cpml_deriv_to(float d, float ik, float a,
                                               float b, float psi_in,
                                               float* psi_out) {
  const float p = __fadd_rn(__fmul_rn(b, psi_in), __fmul_rn(a, d));
  *psi_out = p;
  return __fadd_rn(__fmul_rn(d, ik), p);
}

// cpml_deriv_adj with the carried cotangent read from one buffer and
// written to another.
__device__ __forceinline__ float cpml_deriv_adj_to(float ge, float ik,
                                                   float a, float b,
                                                   float psi_bar_in,
                                                   float* psi_bar_out) {
  const float q = psi_bar_in + ge;
  *psi_bar_out = b * q;
  return ge * ik + a * q;
}

}  // namespace elastic
