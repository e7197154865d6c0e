// The boundary-saving adjoint of the elastic forward on Hopper: from the
// final fields, the saved boundary strips and the data cotangent, run the
// nt-1 steps backwards for all shots, reconstructing the forward state and
// propagating the adjoint state, and return the gradients of the 5 material
// planes (summed over shots) and of every source sample.
//
// Replaces sep2023_tpu/ops/pallas_engine.py::_run_backward (the K2 Pallas
// kernel, pallas_call at line 1186, body _bwd_kernel at line 924, full
// variant, phase-split adjoint), for a RowSurvey and for a FiberSurvey.  At
// grids past the TPU's VMEM range the JAX package runs the same backward as
// pallas_stream.py::_make_bwd_megastep (K4, pallas_call at line 1794); all
// state here lives in device memory at any grid size, so this file is K4's
// counterpart too.  It computes what K2 computes, in reverse
// time, for all shots: strip injection and the interior reconstruction with
// the source subtracted (no CPML), the data cotangent injected at the
// receivers, the adjoint of the velocity and stress half-steps with their
// CPML memory, d_stf at the source cell, and the accumulation of the
// gradients of (lam, lp2m, ave_mu, byc_a, byc_b).  The TPU kernel gets its
// transposes from jax.vjp inside the kernel; here every transpose is written
// out by hand, in gather form (each thread sums what lands on its own cell),
// so there are no atomics and the result is the same from run to run.  The
// primal CPML memory is taken as zero, as the TPU kernel does: gradients are
// kept only inside the interior, where it is zero.  The TPU kernel's compact
// 3-plane variant (_use_compact) is a VMEM economy and is not carried over:
// all planes live in device memory here.  The Pallas kernel rolls
// cyclically at the grid edge; this kernel reads 0 outside the grid, which
// differs only in the PML collar, outside the gradient's interior.
//
// Each shot is a blockIdx.z slice; a host loop steps it = nt-2 .. 0, with
// two launches per step:
//   velocity launch: finish the cotangents of vz/vx after step it (the
//     stress launch's stencil cotangents of step it+1, transposed), add the
//     receivers' cotangent, reconstruct vz/vx before step it from the
//     stresses after it (interior increment subtracted, strips injected),
//     then the velocity half-step's adjoint: psi5..psi8 recursions, the
//     velocity stencils' cotangents into scratch, the buoyancy gradients;
//   stress launch: the stresses' total cotangents (the velocity launch's
//     stencil cotangents transposed, pr at the receivers), d_stf, the
//     stress reconstruction (source subtracted, interior increment
//     subtracted, strips injected), then the stress half-step's adjoint:
//     psi1..psi4, the stress stencils' cotangents into scratch, the
//     gradients of lam, lp2m and ave_mu.
// A stencil transpose reads a neighbour's cotangent, which the launch
// boundary makes visible.  Each launch reads neighbours only of planes that
// no thread writes in it.  After the loop one launch sums the per-shot
// gradient planes over shots in a fixed order.
//
// Point receivers (K1-fiber's transpose).  A receiver at (z, x) sampled vx at
// (z, x), (z, x-1), (z+1, x) and vz at (z, x), (z-1, x), (z, x+1), and
// neighbours on a cable overlap, so one cell can take cotangent from several
// receivers.  A scatter would need atomics and would change the gradient
// from run to run.  Instead the wrapper builds, once per plan, a table in
// compressed-row form: one row per touched (adjoint plane, cell), its
// entries (receiver, channel, coefficient) in a fixed order.  One extra
// launch a step, inject_points_kernel, before the velocity launch: one
// thread per (shot, row) sums its entries against the data cotangent of
// recording index it+1 and adds the sum to its cell of the carried adjoint
// plane (vz, vx, szz or sxx), which the next two launches then read as
// before.  So a fiber backward is 3 (nt-1) + 1 launches, a row backward
// 2 (nt-1) + 1 with the receivers found by arithmetic inside the launches.
//
// What bounds it on this card: 215 FP32 operations per cell-step
// (reconstruction, both adjoint phases, 8 stencils and 8 transposes, the
// accumulation; chip_smoke.py counts them) and, counting each input once
// and each output once, the strips (2.45 GB at the reference workload) and
// the data cotangent read once: operation-bound at 4.0 ms of FP32 peak.  As with the forward,
// one thread per cell with every operand from L1/L2 and device memory is
// bound by the memory traffic instead: about 30 planes of 4 B per
// cell-step.  Shared-memory tiles, temporal blocking and CUDA graphs are
// later work.
//
// Reconstruction uses the increments of elastic_common.cuh, the same code
// and rounding as the forward kernel.

#include "elastic_common.cuh"

namespace {

using namespace elastic;

constexpr int kSumThreads = 256;
constexpr int kInjThreads = 128;

// Plane order of the work buffer (21, S, nz, nx): the adjoint fields (Field
// order), the adjoint psi (propagator.Psi order), and the 8 stencil
// cotangents (scratch) of the stress (D1..D4) and velocity (D5..D8) phases.
enum Work {
  A_VZ = 0, A_VX, A_SZZ, A_SXX, A_SXZ,
  A_P1, A_P2, A_P3, A_P4, A_P5, A_P6, A_P7, A_P8,
  D1, D2, D3, D4, D5, D6, D7, D8,
};

struct Params {
  const float* mats;    // (5, nz, nx)
  const float* prof_z;  // (6, nz)
  const float* prof_x;  // (6, nx)
  const float* stf;     // (S, nt)
  const int* src_z;     // (S,)
  const int* src_x;     // (S,)
  const float* rxz;     // (S,)
  const float* strips;  // (S, nt-1, 5, strip n)
  const float* d_data;  // (S, 4, R, nt)
  // point receivers: the injection table, or inj_ptr null for a receiver row
  const int* inj_ptr;      // (n_inj + 1,) entry range of each row
  const int* inj_plane;    // (n_inj,) A_VZ, A_VX, A_SZZ or A_SXX
  const int* inj_cell;     // (n_inj,) z * nx + x
  const int* ent_rec;      // (n_ent,) receiver
  const int* ent_ch;       // (n_ent,) channel 0..3
  const float* ent_coef;   // (n_ent,)
  float* fields;        // (5, S, nz, nx): the final fields in, state_0 out
  float* work;          // (21, S, nz, nx), zeroed
  float* gshot;         // (S, 5, nz, nx), zeroed
  float* gmat;          // (5, nz, nx)
  float* d_stf;         // (S, nt), zeroed
  int S, nz, nx, nt;
  int rec_row, rec_x0, n_rec, ett_ezz, n_inj, npml;
  float dt, src_amp;    // src_amp = src_scale * dt
  StripGeom sg;
};

__device__ __forceinline__ float* field(const Params& p, int k, int s) {
  return p.fields + plane_offset(k, s, p.S, p.nz, p.nx);
}

__device__ __forceinline__ float* work(const Params& p, int k, int s) {
  return p.work + plane_offset(k, s, p.S, p.nz, p.nx);
}

__device__ __forceinline__ float* grad(const Params& p, int k, int s) {
  return p.gshot + (static_cast<size_t>(s) * kNumFields + k) *
                       static_cast<size_t>(p.nz) * p.nx;
}

__device__ __forceinline__ bool in_interior(const Params& p, int z, int x) {
  return z >= p.npml && z <= p.nz - 1 - p.npml && x >= p.npml &&
         x <= p.nx - 1 - p.npml;
}

// The data cotangent of channel ch, receiver r, at recording index it + 1.
__device__ __forceinline__ float d_rec(const Params& p, int s, int ch, int r,
                                       int it) {
  return p.d_data[((static_cast<size_t>(s) * 4 + ch) * p.n_rec + r) * p.nt +
                  it + 1];
}

// Point receivers' cotangent of recording index it + 1 (see the note at the
// top): one thread per (shot, table row), entries summed in table order.
__global__ void inject_points_kernel(Params p, int it) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= static_cast<size_t>(p.S) * p.n_inj) return;
  const int s = static_cast<int>(idx / p.n_inj);
  const int t = static_cast<int>(idx % p.n_inj);
  float acc = 0.0f;
  for (int j = p.inj_ptr[t]; j < p.inj_ptr[t + 1]; ++j) {
    acc += p.ent_coef[j] * d_rec(p, s, p.ent_ch[j], p.ent_rec[j], it);
  }
  work(p, p.inj_plane[t], s)[p.inj_cell[t]] += acc;
}

// Velocity launch of reverse step it (see the note at the top).
__global__ void bwd_velocity_kernel(Params p, int it) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (x >= p.nx || z >= p.nz) return;
  const int nz = p.nz, nx = p.nx;
  const size_t c = static_cast<size_t>(z) * nx + x;
  const size_t plane_n = static_cast<size_t>(nz) * nx;
  const float* pz = p.prof_z;
  const float* px = p.prof_x;

  // cotangents of vz, vx after step it: carried, plus the stress stencils
  // of step it+1 transposed
  float vz_bar = work(p, A_VZ, s)[c] + dz_minus_t(work(p, D1, s), z, x, nz, nx)
                 + dx_plus_t(work(p, D4, s), z, x, nz, nx);
  float vx_bar = work(p, A_VX, s)[c] + dx_minus_t(work(p, D2, s), z, x, nz, nx)
                 + dz_plus_t(work(p, D3, s), z, x, nz, nx);

  // a receiver row's cotangent (propagator._record transposed); point
  // receivers' arrived in the carried planes (inject_points_kernel)
  if (p.inj_ptr == nullptr) {
    const int r = x - p.rec_x0;
    const bool on_row = r >= 0 && r < p.n_rec;
    if (z == p.rec_row && on_row) {
      vx_bar += d_rec(p, s, 1, r, it);
      vz_bar += d_rec(p, s, 2, r, it);
      if (p.ett_ezz) {
        vz_bar += d_rec(p, s, 3, r, it);   // ett = vz[r, x] - vz[r-1, x]
      } else {
        vx_bar += d_rec(p, s, 3, r, it);   // ett = vx[r, x] - vx[r, x-1]
      }
    }
    if (!p.ett_ezz && z == p.rec_row && r + 1 >= 0 && r + 1 < p.n_rec) {
      vx_bar -= d_rec(p, s, 3, r + 1, it);
    }
    if (p.ett_ezz && z == p.rec_row - 1 && on_row) {
      vz_bar -= d_rec(p, s, 3, r, it);
    }
  }

  // the velocity stencils of the stresses after step it
  const float* szz = field(p, F_SZZ, s);
  const float* sxx = field(p, F_SXX, s);
  const float* sxz = field(p, F_SXZ, s);
  const float d5 = dz_plus(szz, z, x, nz, nx);
  const float d6 = dx_minus(sxz, z, x, nz, nx);
  const float d7 = dz_minus(sxz, z, x, nz, nx);
  const float d8 = dx_plus(sxx, z, x, nz, nx);
  const float byca = p.mats[BYC_A * plane_n + c];
  const float bycb = p.mats[BYC_B * plane_n + c];

  // reconstruct vz, vx before step it
  float* vz = field(p, F_VZ, s) + c;
  float* vx = field(p, F_VX, s) + c;
  int slot[2];
  if (strip_slots(p.sg, z, x, nz, nx, slot) > 0) {
    const float* in = p.strips + strip_offset(p.sg, s, it, p.nt);
    *vz = in[F_VZ * p.sg.n + slot[0]];
    *vx = in[F_VX * p.sg.n + slot[0]];
  } else if (in_interior(p, z, x)) {
    *vz = __fsub_rn(*vz, velocity_increment(
        __fmul_rn(d5, pz[IK_H * nz + z]), __fmul_rn(d6, px[IK * nx + x]),
        byca, p.dt));
    *vx = __fsub_rn(*vx, velocity_increment(
        __fmul_rn(d7, pz[IK * nz + z]), __fmul_rn(d8, px[IK_H * nx + x]),
        bycb, p.dt));
  }

  // the velocity half-step's adjoint and the buoyancy gradients
  float gz = 0.0f, gx = 0.0f;
  if (in_update_mask(z, x, nz, nx)) {
    gz = vz_bar * byca * p.dt;
    gx = vx_bar * bycb * p.dt;
    const float e5 = d5 * pz[IK_H * nz + z] + pz[A_H * nz + z] * d5;
    const float e6 = d6 * px[IK * nx + x] + px[A * nx + x] * d6;
    const float e7 = d7 * pz[IK * nz + z] + pz[A * nz + z] * d7;
    const float e8 = d8 * px[IK_H * nx + x] + px[A_H * nx + x] * d8;
    grad(p, BYC_A, s)[c] += vz_bar * (e5 + e6) * p.dt;
    grad(p, BYC_B, s)[c] += vx_bar * (e7 + e8) * p.dt;
  }
  work(p, D5, s)[c] = cpml_deriv_adj(gz, pz[IK_H * nz + z], pz[A_H * nz + z],
                                     pz[B_H * nz + z], work(p, A_P5, s) + c);
  work(p, D6, s)[c] = cpml_deriv_adj(gz, px[IK * nx + x], px[A * nx + x],
                                     px[B * nx + x], work(p, A_P6, s) + c);
  work(p, D7, s)[c] = cpml_deriv_adj(gx, pz[IK * nz + z], pz[A * nz + z],
                                     pz[B * nz + z], work(p, A_P7, s) + c);
  work(p, D8, s)[c] = cpml_deriv_adj(gx, px[IK_H * nx + x], px[A_H * nx + x],
                                     px[B_H * nx + x], work(p, A_P8, s) + c);
  work(p, A_VZ, s)[c] = vz_bar;
  work(p, A_VX, s)[c] = vx_bar;
}

// Stress launch of reverse step it (see the note at the top).
__global__ void bwd_stress_kernel(Params p, int it) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (x >= p.nx || z >= p.nz) return;
  const int nz = p.nz, nx = p.nx;
  const size_t c = static_cast<size_t>(z) * nx + x;
  const size_t plane_n = static_cast<size_t>(nz) * nx;
  const float* pz = p.prof_z;
  const float* px = p.prof_x;

  // total cotangents of the stresses after step it: carried, plus the
  // velocity stencils transposed, plus pr on a receiver row
  float szz_bar = work(p, A_SZZ, s)[c]
                  + dz_plus_t(work(p, D5, s), z, x, nz, nx);
  float sxx_bar = work(p, A_SXX, s)[c]
                  + dx_plus_t(work(p, D8, s), z, x, nz, nx);
  const float sxz_bar = work(p, A_SXZ, s)[c]
                        + dx_minus_t(work(p, D6, s), z, x, nz, nx)
                        + dz_minus_t(work(p, D7, s), z, x, nz, nx);
  const int r = x - p.rec_x0;
  if (p.inj_ptr == nullptr && z == p.rec_row && r >= 0 && r < p.n_rec) {
    const float pr = d_rec(p, s, 0, r, it);
    szz_bar += pr;
    sxx_bar += pr;
  }
  const bool src = z == p.src_z[s] && x == p.src_x[s];
  if (src) {
    p.d_stf[static_cast<size_t>(s) * p.nt + it] =
        p.src_amp * (szz_bar + p.rxz[s] * sxx_bar);
  }

  // the stress stencils of the velocities before step it
  const float* vz = field(p, F_VZ, s);
  const float* vx = field(p, F_VX, s);
  const float d1 = dz_minus(vz, z, x, nz, nx);
  const float d2 = dx_minus(vx, z, x, nz, nx);
  const float d3 = dz_plus(vx, z, x, nz, nx);
  const float d4 = dx_plus(vz, z, x, nz, nx);

  // reconstruct the stresses before step it
  float* szz = field(p, F_SZZ, s) + c;
  float* sxx = field(p, F_SXX, s) + c;
  float* sxz = field(p, F_SXZ, s) + c;
  int slot[2];
  if (strip_slots(p.sg, z, x, nz, nx, slot) > 0) {
    const float* in = p.strips + strip_offset(p.sg, s, it, p.nt);
    *szz = in[F_SZZ * p.sg.n + slot[0]];
    *sxx = in[F_SXX * p.sg.n + slot[0]];
    *sxz = in[F_SXZ * p.sg.n + slot[0]];
  } else {
    float new_szz = *szz, new_sxx = *sxx, new_sxz = *sxz;
    if (src) {
      const float amp = source_amp(p.stf, s, it, p.nt, p.src_amp);
      new_szz = __fsub_rn(new_szz, amp);
      new_sxx = __fsub_rn(new_sxx, __fmul_rn(p.rxz[s], amp));
    }
    if (in_interior(p, z, x)) {
      const StressInc inc = stress_increment(
          __fmul_rn(d1, pz[IK * nz + z]), __fmul_rn(d2, px[IK * nx + x]),
          __fmul_rn(d3, pz[IK_H * nz + z]), __fmul_rn(d4, px[IK_H * nx + x]),
          p.mats, plane_n, c, p.dt);
      new_szz = __fsub_rn(new_szz, inc.zz);
      new_sxx = __fsub_rn(new_sxx, inc.xx);
      new_sxz = __fsub_rn(new_sxz, inc.xz);
    }
    *szz = new_szz;
    *sxx = new_sxx;
    *sxz = new_sxz;
  }

  // the stress half-step's adjoint and the gradients of lam, lp2m, ave_mu
  float ge_zz = 0.0f, ge_xx = 0.0f, ge_s = 0.0f;
  if (in_update_mask(z, x, nz, nx)) {
    const float lam = p.mats[LAM * plane_n + c];
    const float lp2m = p.mats[LP2M * plane_n + c];
    const float mu = p.mats[AVE_MU * plane_n + c];
    const float hzz = szz_bar * p.dt;
    const float hxx = sxx_bar * p.dt;
    const float hxz = sxz_bar * p.dt;
    const float e1 = d1 * pz[IK * nz + z] + pz[A * nz + z] * d1;
    const float e2 = d2 * px[IK * nx + x] + px[A * nx + x] * d2;
    const float e3 = d3 * pz[IK_H * nz + z] + pz[A_H * nz + z] * d3;
    const float e4 = d4 * px[IK_H * nx + x] + px[A_H * nx + x] * d4;
    grad(p, LAM, s)[c] += hzz * e2 + hxx * e1;
    grad(p, LP2M, s)[c] += hzz * e1 + hxx * e2;
    grad(p, AVE_MU, s)[c] += hxz * (e3 + e4);
    ge_zz = lp2m * hzz + lam * hxx;
    ge_xx = lam * hzz + lp2m * hxx;
    ge_s = mu * hxz;
  }
  work(p, D1, s)[c] = cpml_deriv_adj(ge_zz, pz[IK * nz + z], pz[A * nz + z],
                                     pz[B * nz + z], work(p, A_P1, s) + c);
  work(p, D2, s)[c] = cpml_deriv_adj(ge_xx, px[IK * nx + x], px[A * nx + x],
                                     px[B * nx + x], work(p, A_P2, s) + c);
  work(p, D3, s)[c] = cpml_deriv_adj(ge_s, pz[IK_H * nz + z], pz[A_H * nz + z],
                                     pz[B_H * nz + z], work(p, A_P3, s) + c);
  work(p, D4, s)[c] = cpml_deriv_adj(ge_s, px[IK_H * nx + x], px[A_H * nx + x],
                                     px[B_H * nx + x], work(p, A_P4, s) + c);
  work(p, A_SZZ, s)[c] = szz_bar;
  work(p, A_SXX, s)[c] = sxx_bar;
  work(p, A_SXZ, s)[c] = sxz_bar;
}

// gmat[k, c] = sum over s = 0 .. S-1, in that order, of gshot[s, k, c].
__global__ void sum_shots_kernel(Params p) {
  const size_t n = kNumFields * static_cast<size_t>(p.nz) * p.nx;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= n) return;
  float acc = 0.0f;
  for (int s = 0; s < p.S; ++s) acc += p.gshot[s * n + idx];
  p.gmat[idx] = acc;
}

}  // namespace

// Runs the nt-1 reverse steps for all shots and the shot sum on `stream`
// (2 (nt-1) + 1 launches for a receiver row, 3 (nt-1) + 1 with an injection
// table of n_inj rows for point receivers, inj_ptr null and n_inj 0
// otherwise); returns the first CUDA error (0 on success).
// Does not synchronise and allocates nothing: `fields` holds the final
// fields and is overwritten with the reconstructed fields at t=0; `work`,
// `gshot` and `d_stf` arrive zeroed; `gmat` receives the gradients.
extern "C" int elastic_backward(const float* mats, const float* prof_z,
                                const float* prof_x, const float* stf,
                                const int* src_z, const int* src_x,
                                const float* rxz, const float* strips,
                                const float* d_data, const int* inj_ptr,
                                const int* inj_plane, const int* inj_cell,
                                const int* ent_rec, const int* ent_ch,
                                const float* ent_coef, float* fields,
                                float* work, float* gshot, float* gmat,
                                float* d_stf, int S, int nz, int nx, int nt,
                                int rec_row, int rec_x0, int n_rec,
                                int ett_mode, int n_inj, int npml, int n_bnd,
                                float dt, float src_amp, void* stream) {
  Params p{mats, prof_z, prof_x, stf, src_z, src_x, rxz, strips, d_data,
           inj_ptr, inj_plane, inj_cell, ent_rec, ent_ch, ent_coef,
           fields, work, gshot, gmat, d_stf, S, nz, nx, nt, rec_row, rec_x0,
           n_rec, ett_mode == elastic::ETT_EZZ, n_inj, npml, dt, src_amp,
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
      inject_points_kernel<<<inj_blocks, kInjThreads, 0, st>>>(p, it);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    bwd_velocity_kernel<<<grid, block, 0, st>>>(p, it);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_stress_kernel<<<grid, block, 0, st>>>(p, it);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t n = kNumFields * static_cast<size_t>(nz) * nx;
  const int blocks = static_cast<int>((n + kSumThreads - 1) / kSumThreads);
  sum_shots_kernel<<<blocks, kSumThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
