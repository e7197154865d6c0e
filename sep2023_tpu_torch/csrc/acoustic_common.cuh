// Arithmetic shared by the acoustic forward kernel (acoustic_fwd.cu) and the
// acoustic backward kernel (acoustic_bwd.cu), on top of elastic_common.cuh:
// the plane orders and the interior increments of the pressure and velocity
// half-steps.  As there, every operation of an increment is an explicit
// round-to-nearest intrinsic, so the reverse step subtracts the very float
// the forward step added.

#pragma once

#include "elastic_common.cuh"

namespace acoustic {

using namespace elastic;

constexpr int kAcFields = 3;

// Field order of every (3, S, nz, nx) buffer and of the strips: AcFields.
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

}  // namespace acoustic
