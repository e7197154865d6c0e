// Arithmetic shared by the acoustic forward kernel (acoustic_fwd.cu) and the
// acoustic backward kernel (acoustic_bwd.cu), on top of elastic_common.cuh:
// the plane orders, the interior increments of the pressure and velocity
// half-steps, and the shared memory of the fused step kernels.  As there,
// every operation of an increment is an explicit round-to-nearest
// intrinsic, so the reverse step subtracts the very float the forward step
// added.

#pragma once

#include "elastic_common.cuh"

namespace acoustic {

using namespace elastic;

constexpr int kAcFields = 3;

// Field order of every (2, 3, S, nz, nx) buffer and of the strips: AcFields.
enum AcField { F_P = 0, F_VZ_AC, F_VX_AC };

// Material planes (3, nz, nx): lam = rho vp^2 and the two buoyancies.
enum AcMat { M_LAM = 0, M_BYC_A, M_BYC_B };

// The pressure half-step's increment: lam (e_vz + e_vx) dt
// (acoustic.ac_step; acoustic._pressure_reverse with e = D (1/dh)).
__device__ __forceinline__ float pressure_increment(float e_vz, float e_vx,
                                                    float lam, float dt) {
  return __fmul_rn(__fmul_rn(lam, __fadd_rn(e_vz, e_vx)), dt);
}

// The velocity half-step's increment of one component: e byc dt.
__device__ __forceinline__ float ac_velocity_increment(float e, float byc,
                                                       float dt) {
  return __fmul_rn(__fmul_rn(e, byc), dt);
}

// The fused step kernels run on the elastic kernels' tiles (kTileZ x
// kTileX cells a block, kTileThreads threads, elastic_common.cuh).  Their
// shared memory in floats, every value a step reads copied in at the top of
// the block (the layouts are in acoustic_fwd.cu and acoustic_bwd.cu).  The
// forward: vz, vx with the 4-cell halo; p, lam and the pressure phase's 2
// CPML memories with the 2-cell halo; 2 buoyancies and the velocity phase's
// 2 memories on the tile.  The backward: the carried p and the pressure
// phase's stencil cotangents D1, D2 with the 4-cell halo; the cotangents of
// vz, vx, the velocities, 2 buoyancies and the velocity phase's 2 adjoint
// memories with the 2-cell halo; the cotangent of p, lam, the image
// coefficient and the pressure phase's 2 adjoint memories on the tile; and
// a point-receiver row's sum and where it lands, a thread, and the block's
// runs of rows (3 ints).  The
// accumulators are read and written in device memory by the owner of their
// cell alone.
constexpr int kAcFwdShared = 2 * kH4 + 4 * kH2 + 4 * kT;
constexpr int kAcBwdShared =
    3 * kH4 + 8 * kH2 + 5 * kT + 2 * kTileThreads + 3;
// Both fit the 48 KiB of static shared memory a block; four forward blocks
// and four backward blocks fit an SM's 228 KiB (1 KiB of it reserved a
// block), so registers, not shared memory, set how many run at once.
static_assert(kAcFwdShared * sizeof(float) <= 48 * 1024,
              "static shared memory of ac_fwd_step_kernel");
static_assert(kAcBwdShared * sizeof(float) <= 48 * 1024,
              "static shared memory of ac_bwd_step_kernel");
static_assert(4 * (kAcBwdShared * sizeof(float) + 1024) <= 228 * 1024,
              "four blocks of ac_bwd_step_kernel an SM");

}  // namespace acoustic
