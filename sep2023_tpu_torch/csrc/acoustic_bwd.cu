// The boundary-saving adjoint of the acoustic forward on Hopper: from the
// final fields, the saved boundary strips and the data cotangent, run the
// nt-1 steps backwards for all shots, reconstructing the forward state and
// propagating the adjoint state, and return either the gradients of the 3
// material planes (lam, byc_a, byc_b; summed over shots) and of every source
// sample, or, as the imaging variant, the time-derivative RTM image and the
// source illumination.
//
// Replaces sep2023_tpu/ops/pallas_engine.py::_ac_run_backward (the K6 Pallas
// kernel, pallas_call at line 1746, body _ac_bwd_kernel at line 1539,
// phase-split adjoint).  At grids past the TPU's VMEM range the JAX package
// runs the same backward as pallas_stream.py::_make_ac_bwd_megastep (K8,
// pallas_call at line 2493); all state here lives in device memory at any
// grid size, so this file is K8's counterpart too.  The imaging variant is
// the route on this card of sep2023_tpu/acoustic.py::rtm_image_time
// (lines 224-284), which the JAX package leaves to its XLA engine: the same
// reverse loop with two more accumulators.  The TPU kernel gets its
// transposes from jax.vjp inside the kernel; here every transpose is written
// out by hand, in gather form, so there are no atomics and the result is the
// same from run to run.  The primal CPML memory is taken as zero, as the TPU
// kernel does: results are kept only inside the tight interior, where it is
// zero.  The Pallas kernel rolls cyclically at the grid edge; this kernel
// reads 0 outside the grid, which differs only in the PML collar.
//
// The forward step is pressure first: p takes the old velocities and the
// source, then vz and vx take that new p.  So the reverse step undoes the
// velocities first, with the carried p(t+1), and subtracts the source
// before it undoes the pressure.  Each shot is a blockIdx.z slice; a host
// loop steps it = nt-2 .. 0, with two launches per step:
//   velocity launch: finish the cotangents of vz/vx after step it (the
//     pressure launch's stencil cotangents of step it+1, transposed), add a
//     receiver row's cotangent, take the stencils of the carried p(t+1),
//     reconstruct vz/vx before step it (interior increment subtracted inside
//     the tight interior, strips injected), then the velocity half-step's
//     adjoint: the two psi recursions, the p-stencils' cotangents into
//     scratch, the buoyancy gradients;
//   pressure launch: the total cotangent of p after step it (carried, plus
//     the recorded-p cotangent, plus the velocity launch's scratch planes
//     transposed), d_stf at the source cell, the stencils of the
//     reconstructed vz/vx, the pressure reconstruction (source subtracted,
//     interior increment subtracted, strips injected), the image and
//     illumination accumulators when asked for, then the pressure
//     half-step's adjoint: the two psi recursions, the v-stencils'
//     cotangents into scratch (the next step's velocity launch transposes
//     them), the gradient of lam.
// A stencil transpose reads a neighbour's cotangent, which the launch
// boundary makes visible; each launch reads neighbours only of planes that
// no thread writes in it.  That fixes 4 scratch planes and 2 launches a step.
// After the loop one launch sums the per-shot accumulator planes over shots
// in a fixed order.
//
// The tight interior [npml+2, n-3-npml] (acoustic._consts) is where the
// reconstruction updates; the strips keep the elastic bounds and overlap
// its first and last cell, where they take precedence.
//
// Point receivers: as in elastic_bwd.cu, an injection table in
// compressed-row form (one row per touched (adjoint plane, cell)), one extra
// launch a step before the velocity launch, no atomics.  A sample reads no
// neighbour, so a row has one entry per receiver on its cell.
//
// What bounds it on this card: 105 FP32 operations per cell-step (102 in the
// imaging variant; chip_smoke.py counts them) against 14 planes of state
// (3 fields, 3 adjoint fields, 4 adjoint psi, 4 scratch), 3 material planes
// and 3 accumulators; the strips and the data cotangent are read once.  One
// thread per cell with operands from L1/L2 and device memory is bound by
// the memory traffic.
//
// Reconstruction uses the increments of acoustic_common.cuh, the same code
// and rounding as the forward kernel.

#include "acoustic_common.cuh"

namespace {

using namespace acoustic;

constexpr int kSumThreads = 256;
constexpr int kInjThreads = 128;

// Plane order of the work buffer (11, S, nz, nx): the adjoint fields
// (AcField order), the adjoint psi (acoustic.AcPsi order), and the 4 stencil
// cotangents (scratch) of the pressure (D1, D2) and velocity (D3, D4)
// phases.
enum Work {
  A_P = 0, A_VZ, A_VX, A_P1, A_P2, A_P3, A_P4, D1, D2, D3, D4,
};

// Per-shot accumulator planes (S, n_acc, nz, nx): the gradients of the 3
// material planes (AcMat order), or the image and the illumination.
enum Acc { ACC_IMG = 0, ACC_ILL = 1 };

struct Params {
  const float* mats;      // (3, nz, nx): lam, byc_a, byc_b
  const float* prof_z;    // (6, nz)
  const float* prof_x;    // (6, nx)
  const float* stf;       // (S, nt)
  const int* src_z;       // (S,)
  const int* src_x;       // (S,)
  const float* strips;    // (S, nt-1, 3, strip n)
  const float* d_data;    // (S, 3, R, nt)
  // point receivers: the injection table, or inj_ptr null for a receiver row
  const int* inj_ptr;     // (n_inj + 1,) entry range of each row
  const int* inj_plane;   // (n_inj,) A_P, A_VZ or A_VX
  const int* inj_cell;    // (n_inj,) z * nx + x
  const int* ent_rec;     // (n_ent,) receiver
  const int* ent_ch;      // (n_ent,) channel 0..2
  const float* ent_coef;  // (n_ent,)
  const float* img_coef;  // (nz, nx) -2 / vp: the imaging variant; or null
  float* fields;          // (3, S, nz, nx): the final fields in, state_0 out
  float* work;            // (11, S, nz, nx), zeroed
  float* acc;             // (S, n_acc, nz, nx), zeroed
  float* acc_sum;         // (n_acc, nz, nx)
  float* d_stf;           // (S, nt), zeroed
  int S, nz, nx, nt;
  int rec_row, rec_x0, n_rec, n_inj, npml, n_acc;
  float dt, src_amp;      // src_amp = src_scale * dt
  StripGeom sg;
};

__device__ __forceinline__ float* field(const Params& p, int k, int s) {
  return p.fields + plane_offset(k, s, p.S, p.nz, p.nx);
}

__device__ __forceinline__ float* work(const Params& p, int k, int s) {
  return p.work + plane_offset(k, s, p.S, p.nz, p.nx);
}

__device__ __forceinline__ float* acc(const Params& p, int k, int s) {
  return p.acc + (static_cast<size_t>(s) * p.n_acc + k) *
                     static_cast<size_t>(p.nz) * p.nx;
}

__device__ __forceinline__ bool in_tight_interior(const Params& p, int z,
                                                  int x) {
  return z >= p.npml + 2 && z <= p.nz - 3 - p.npml && x >= p.npml + 2 &&
         x <= p.nx - 3 - p.npml;
}

// The data cotangent of channel ch, receiver r, at recording index it + 1.
__device__ __forceinline__ float d_rec(const Params& p, int s, int ch, int r,
                                       int it) {
  return p.d_data[((static_cast<size_t>(s) * kAcFields + ch) * p.n_rec + r) *
                      p.nt + it + 1];
}

// Point receivers' cotangent of recording index it + 1: one thread per
// (shot, table row), entries summed in table order.
__global__ void ac_inject_points_kernel(Params p, int it) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= static_cast<size_t>(p.S) * p.n_inj) return;
  const int s = static_cast<int>(idx / p.n_inj);
  const int t = static_cast<int>(idx % p.n_inj);
  float sum = 0.0f;
  for (int j = p.inj_ptr[t]; j < p.inj_ptr[t + 1]; ++j) {
    sum += p.ent_coef[j] * d_rec(p, s, p.ent_ch[j], p.ent_rec[j], it);
  }
  work(p, p.inj_plane[t], s)[p.inj_cell[t]] += sum;
}

// Velocity launch of reverse step it (see the note at the top).
__global__ void ac_bwd_velocity_kernel(Params p, int it) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (x >= p.nx || z >= p.nz) return;
  const int nz = p.nz, nx = p.nx;
  const size_t c = static_cast<size_t>(z) * nx + x;
  const size_t plane_n = static_cast<size_t>(nz) * nx;
  const float* pz = p.prof_z;
  const float* px = p.prof_x;

  // cotangents of vz, vx after step it: carried, plus the pressure stencils
  // of step it+1 transposed
  float vz_bar = work(p, A_VZ, s)[c] + dz_plus_t(work(p, D1, s), z, x, nz, nx);
  float vx_bar = work(p, A_VX, s)[c]
                 + dx_minus_t(work(p, D2, s), z, x, nz, nx);
  // a receiver row's cotangent; point receivers' arrived in the carried
  // planes (ac_inject_points_kernel)
  const int r = x - p.rec_x0;
  if (p.inj_ptr == nullptr && z == p.rec_row && r >= 0 && r < p.n_rec) {
    vx_bar += d_rec(p, s, 1, r, it);
    vz_bar += d_rec(p, s, 2, r, it);
  }

  // the velocity stencils of the carried (post-source) p after step it
  const float* pr = field(p, F_P, s);
  const float d3 = dz_minus(pr, z, x, nz, nx);
  const float d4 = dx_plus(pr, z, x, nz, nx);
  const float byca = p.mats[M_BYC_A * plane_n + c];
  const float bycb = p.mats[M_BYC_B * plane_n + c];

  // reconstruct vz, vx before step it
  float* vz = field(p, F_VZ_AC, s) + c;
  float* vx = field(p, F_VX_AC, s) + c;
  int slot[2];
  if (strip_slots(p.sg, z, x, nz, nx, slot) > 0) {
    const float* in = p.strips + strip_offset(p.sg, s, it, p.nt, kAcFields);
    *vz = in[F_VZ_AC * p.sg.n + slot[0]];
    *vx = in[F_VX_AC * p.sg.n + slot[0]];
  } else if (in_tight_interior(p, z, x)) {
    *vz = __fsub_rn(*vz, ac_velocity_increment(
        __fmul_rn(d3, pz[IK * nz + z]), byca, p.dt));
    *vx = __fsub_rn(*vx, ac_velocity_increment(
        __fmul_rn(d4, px[IK_H * nx + x]), bycb, p.dt));
  }

  // the velocity half-step's adjoint and the buoyancy gradients
  float gz = 0.0f, gx = 0.0f;
  if (in_update_mask(z, x, nz, nx)) {
    gz = vz_bar * byca * p.dt;
    gx = vx_bar * bycb * p.dt;
    if (p.img_coef == nullptr) {
      const float e3 = d3 * pz[IK * nz + z] + pz[A * nz + z] * d3;
      const float e4 = d4 * px[IK_H * nx + x] + px[A_H * nx + x] * d4;
      acc(p, M_BYC_A, s)[c] += vz_bar * e3 * p.dt;
      acc(p, M_BYC_B, s)[c] += vx_bar * e4 * p.dt;
    }
  }
  work(p, D3, s)[c] = cpml_deriv_adj(gz, pz[IK * nz + z], pz[A * nz + z],
                                     pz[B * nz + z], work(p, A_P3, s) + c);
  work(p, D4, s)[c] = cpml_deriv_adj(gx, px[IK_H * nx + x], px[A_H * nx + x],
                                     px[B_H * nx + x], work(p, A_P4, s) + c);
  work(p, A_VZ, s)[c] = vz_bar;
  work(p, A_VX, s)[c] = vx_bar;
}

// Pressure launch of reverse step it (see the note at the top).
__global__ void ac_bwd_pressure_kernel(Params p, int it) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (x >= p.nx || z >= p.nz) return;
  const int nz = p.nz, nx = p.nx;
  const size_t c = static_cast<size_t>(z) * nx + x;
  const size_t plane_n = static_cast<size_t>(nz) * nx;
  const float* pz = p.prof_z;
  const float* px = p.prof_x;

  // total cotangent of p after step it: carried, plus the velocity stencils
  // transposed, plus the recorded p on a receiver row
  float p_bar = work(p, A_P, s)[c] + dz_minus_t(work(p, D3, s), z, x, nz, nx)
                + dx_plus_t(work(p, D4, s), z, x, nz, nx);
  const int r = x - p.rec_x0;
  if (p.inj_ptr == nullptr && z == p.rec_row && r >= 0 && r < p.n_rec) {
    p_bar += d_rec(p, s, 0, r, it);
  }
  const bool src = z == p.src_z[s] && x == p.src_x[s];
  if (src) {
    p.d_stf[static_cast<size_t>(s) * p.nt + it] = p.src_amp * p_bar;
  }

  // the pressure stencils of the velocities before step it
  const float d1 = dz_plus(field(p, F_VZ_AC, s), z, x, nz, nx);
  const float d2 = dx_minus(field(p, F_VX_AC, s), z, x, nz, nx);
  const float lam = p.mats[M_LAM * plane_n + c];

  // reconstruct p before step it
  float* pr = field(p, F_P, s) + c;
  const float p_after = *pr;
  float p_before = p_after;
  int slot[2];
  if (strip_slots(p.sg, z, x, nz, nx, slot) > 0) {
    const float* in = p.strips + strip_offset(p.sg, s, it, p.nt, kAcFields);
    p_before = in[F_P * p.sg.n + slot[0]];
  } else {
    if (src) {
      p_before = __fsub_rn(p_before,
                           source_amp(p.stf, s, it, p.nt, p.src_amp));
    }
    if (in_tight_interior(p, z, x)) {
      p_before = __fsub_rn(p_before, pressure_increment(
          __fmul_rn(d1, pz[IK_H * nz + z]), __fmul_rn(d2, px[IK * nx + x]),
          lam, p.dt));
    }
  }
  *pr = p_before;

  // the imaging condition (acoustic.rtm_image_time): the time derivative of
  // the forward pressure against the adjoint pressure, and the source energy
  if (p.img_coef != nullptr) {
    acc(p, ACC_IMG, s)[c] += p.img_coef[c] * (p_after - p_before) * p_bar;
    acc(p, ACC_ILL, s)[c] += p_before * p_before;
  }

  // the pressure half-step's adjoint and the gradient of lam
  float ge = 0.0f;
  if (in_update_mask(z, x, nz, nx)) {
    const float h = p_bar * p.dt;
    if (p.img_coef == nullptr) {
      const float e1 = d1 * pz[IK_H * nz + z] + pz[A_H * nz + z] * d1;
      const float e2 = d2 * px[IK * nx + x] + px[A * nx + x] * d2;
      acc(p, M_LAM, s)[c] += h * (e1 + e2);
    }
    ge = lam * h;
  }
  work(p, D1, s)[c] = cpml_deriv_adj(ge, pz[IK_H * nz + z], pz[A_H * nz + z],
                                     pz[B_H * nz + z], work(p, A_P1, s) + c);
  work(p, D2, s)[c] = cpml_deriv_adj(ge, px[IK * nx + x], px[A * nx + x],
                                     px[B * nx + x], work(p, A_P2, s) + c);
  work(p, A_P, s)[c] = p_bar;
}

// acc_sum[k, c] = sum over s = 0 .. S-1, in that order, of acc[s, k, c].
__global__ void ac_sum_shots_kernel(Params p) {
  const size_t n = p.n_acc * static_cast<size_t>(p.nz) * p.nx;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= n) return;
  float sum = 0.0f;
  for (int s = 0; s < p.S; ++s) sum += p.acc[s * n + idx];
  p.acc_sum[idx] = sum;
}

}  // namespace

// Runs the nt-1 reverse steps for all shots and the shot sum on `stream`
// (2 (nt-1) + 1 launches for a receiver row, 3 (nt-1) + 1 with an injection
// table of n_inj rows for point receivers, inj_ptr null and n_inj 0
// otherwise); returns the first CUDA error (0 on success).  Does not
// synchronise and allocates nothing: `fields` holds the final fields and is
// overwritten with the reconstructed fields at t=0; `work`, `acc` and
// `d_stf` arrive zeroed.  With img_coef null, `acc` is (S, 3, nz, nx) and
// `acc_sum` (3, nz, nx) receives the gradients of (lam, byc_a, byc_b); with
// img_coef the (nz, nx) plane -2 / vp, `acc` is (S, 2, nz, nx), the image
// and the illumination of every shot, and `acc_sum` (2, nz, nx) their sums
// over shots.
extern "C" int acoustic_backward(const float* mats, const float* prof_z,
                                 const float* prof_x, const float* stf,
                                 const int* src_z, const int* src_x,
                                 const float* strips, const float* d_data,
                                 const int* inj_ptr, const int* inj_plane,
                                 const int* inj_cell, const int* ent_rec,
                                 const int* ent_ch, const float* ent_coef,
                                 const float* img_coef, float* fields,
                                 float* work, float* acc, float* acc_sum,
                                 float* d_stf, int S, int nz, int nx, int nt,
                                 int rec_row, int rec_x0, int n_rec,
                                 int n_inj, int npml, int n_bnd, float dt,
                                 float src_amp, void* stream) {
  const int n_acc = img_coef == nullptr ? 3 : 2;
  Params p{mats, prof_z, prof_x, stf, src_z, src_x, strips, d_data,
           inj_ptr, inj_plane, inj_cell, ent_rec, ent_ch, ent_coef, img_coef,
           fields, work, acc, acc_sum, d_stf, S, nz, nx, nt, rec_row, rec_x0,
           n_rec, n_inj, npml, n_acc, dt, src_amp,
           strip_geom(nz, nx, npml, n_bnd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kBlockX, kBlockZ, 1);
  const dim3 grid((nx + kBlockX - 1) / kBlockX, (nz + kBlockZ - 1) / kBlockZ,
                  S);
  const size_t inj_threads = static_cast<size_t>(S) * n_inj;
  const int inj_blocks =
      static_cast<int>((inj_threads + kInjThreads - 1) / kInjThreads);
  for (int it = nt - 2; it >= 0; --it) {
    cudaError_t err;
    if (inj_ptr != nullptr) {
      ac_inject_points_kernel<<<inj_blocks, kInjThreads, 0, st>>>(p, it);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    ac_bwd_velocity_kernel<<<grid, block, 0, st>>>(p, it);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ac_bwd_pressure_kernel<<<grid, block, 0, st>>>(p, it);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t n = n_acc * static_cast<size_t>(nz) * nx;
  const int blocks = static_cast<int>((n + kSumThreads - 1) / kSumThreads);
  ac_sum_shots_kernel<<<blocks, kSumThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
