// Acoustic forward modeling on Hopper: nt-1 leapfrog steps of the O(4)
// staggered pressure-velocity scheme (p, vz, vx) with division-free CPML, a
// point source into p and recording of (pr = p, vx, vz) on a receiver row
// or at arbitrary receiver points, for all shots, and optionally the
// boundary strips of every step for the gradient and the imaging condition.
//
// Replaces sep2023_tpu/ops/pallas_engine.py::_ac_run_forward (the K5 Pallas
// kernel, pallas_call at line 1512, body _ac_fwd_body, step
// _ac_step_values), with save_strips False (forward modeling) and True (the
// gradient's forward, _pa_fwd).  At grids past the TPU's VMEM range the JAX
// package runs the same physics as
// pallas_stream.py::_make_ac_fwd_megastep (K7, pallas_call at line 2167);
// all state here lives in device memory at any grid size, so this file is
// K7's counterpart too.  It computes what K5 computes; the TPU layout
// (lane padding, cyclic rolls, strip staging, z-tiles, the DMA ring, ghost
// steps, band-compact psi) is not carried over.  A stencil neighbour outside
// the grid reads as 0; inside the update mask [2, n-3] both edge rules give
// the same values.
//
// Pressure first: the pressure launch updates p from the old velocities and
// adds the source; the velocity launch updates vz and vx from that new,
// post-source p.  Three launches a step:
//   pressure launch: 2 velocity-derivative psi everywhere, p under the mask,
//     the source; with a strip buffer it first writes the pre-step values of
//     all three fields at every strip cell (acoustic._save_bnd): its own p
//     before updating it, and vz and vx, which no thread writes in this
//     launch;
//   velocity launch: 2 pressure-derivative psi everywhere, vz and vx under
//     the mask;
//   record launch: one thread per (shot, receiver) copies p, vx and vz at the
//     receiver's cell into data[s, :, r, it + 1].  A sample has no neighbour,
//     so it could ride in the velocity launch for a receiver row; it stays a
//     launch of its own so that a row and points (which may visit a cell
//     twice) run the same three launches.
// The final fields are the first 3 planes of the state buffer.
//
// What bounds it on this card: 50 FP32 operations per cell-step (4
// stencils, 4 CPML recursions, the increments; chip_smoke.py counts them)
// against 7 state planes and 3 material planes; counting each input once and
// each output once it is operation-bound with and without strips (the strips
// of a step are 2 n_bnd (nz + nx) values a field, far fewer than the cells),
// while one thread per cell with operands from L1/L2 and device memory is in
// fact bound by the memory traffic.  Tiles, temporal blocking and CUDA
// graphs are later work.
//
// Rounding: the stencils, the interior increments and the source use the
// shared code of elastic_common.cuh and acoustic_common.cuh, with explicit
// rounding, so that the backward kernel's reconstruction subtracts exactly
// what this kernel adds.

#include "acoustic_common.cuh"

namespace {

using namespace acoustic;

constexpr int kRecThreads = 128;

// Plane order of the state buffer (7, S, nz, nx): the 3 fields (AcField
// order), then the 4 CPML psi (acoustic.AcPsi order).
enum AcPsi { P_VZ_DZ = 3, P_VX_DX, P_P_DZ, P_P_DX };

struct Params {
  const float* mats;    // (3, nz, nx): lam, byc_a, byc_b
  const float* prof_z;  // (6, nz)
  const float* prof_x;  // (6, nx)
  const float* stf;     // (S, nt)
  const int* src_z;     // (S,)
  const int* src_x;     // (S,)
  const int* rec_z;     // (R,) receiver points, or null for a receiver row
  const int* rec_x;     // (R,)
  float* state;         // (7, S, nz, nx)
  float* data;          // (S, 3, R, nt)
  float* strips;        // (S, nt-1, 3, strip n), or null
  int S, nz, nx, nt;
  int rec_row, rec_x0, n_rec;
  float dt, src_amp;    // src_amp = src_scale * dt
  StripGeom sg;
};

__device__ __forceinline__ float* plane(const Params& p, int k, int s) {
  return p.state + plane_offset(k, s, p.S, p.nz, p.nx);
}

// Pressure half-step and source (acoustic.ac_step, first half).
__global__ void ac_pressure_kernel(Params p, int it) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (x >= p.nx || z >= p.nz) return;
  const int nz = p.nz, nx = p.nx;
  const size_t c = static_cast<size_t>(z) * nx + x;
  const size_t plane_n = static_cast<size_t>(nz) * nx;
  const float* vz = plane(p, F_VZ_AC, s);
  const float* vx = plane(p, F_VX_AC, s);
  const float* pz = p.prof_z;
  const float* px = p.prof_x;
  float* pr = plane(p, F_P, s) + c;

  if (p.strips != nullptr) {
    int slot[2];
    const int n_slots = strip_slots(p.sg, z, x, nz, nx, slot);
    if (n_slots > 0) {
      const float vals[kAcFields] = {*pr, vz[c], vx[c]};
      float* out = p.strips + strip_offset(p.sg, s, it, p.nt, kAcFields);
      for (int k = 0; k < n_slots; ++k) {
        for (int f = 0; f < kAcFields; ++f) {
          out[static_cast<size_t>(f) * p.sg.n + slot[k]] = vals[f];
        }
      }
    }
  }

  const float e_vz = cpml_deriv(
      dz_plus(vz, z, x, nz, nx), pz[IK_H * nz + z], pz[A_H * nz + z],
      pz[B_H * nz + z], plane(p, P_VZ_DZ, s) + c);
  const float e_vx = cpml_deriv(
      dx_minus(vx, z, x, nz, nx), px[IK * nx + x], px[A * nx + x],
      px[B * nx + x], plane(p, P_VX_DX, s) + c);

  if (in_update_mask(z, x, nz, nx)) {
    *pr = __fadd_rn(*pr, pressure_increment(
        e_vz, e_vx, p.mats[M_LAM * plane_n + c], p.dt));
  }
  if (z == p.src_z[s] && x == p.src_x[s]) {
    *pr = __fadd_rn(*pr, source_amp(p.stf, s, it, p.nt, p.src_amp));
  }
}

// Velocity half-step on the new, post-source pressure.
__global__ void ac_velocity_kernel(Params p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (x >= p.nx || z >= p.nz) return;
  const int nz = p.nz, nx = p.nx;
  const size_t c = static_cast<size_t>(z) * nx + x;
  const size_t plane_n = static_cast<size_t>(nz) * nx;
  const float* pr = plane(p, F_P, s);
  const float* pz = p.prof_z;
  const float* px = p.prof_x;

  const float e_pz = cpml_deriv(
      dz_minus(pr, z, x, nz, nx), pz[IK * nz + z], pz[A * nz + z],
      pz[B * nz + z], plane(p, P_P_DZ, s) + c);
  const float e_px = cpml_deriv(
      dx_plus(pr, z, x, nz, nx), px[IK_H * nx + x], px[A_H * nx + x],
      px[B_H * nx + x], plane(p, P_P_DX, s) + c);

  if (in_update_mask(z, x, nz, nx)) {
    float* vz = plane(p, F_VZ_AC, s) + c;
    float* vx = plane(p, F_VX_AC, s) + c;
    *vz = __fadd_rn(*vz, ac_velocity_increment(
        e_pz, p.mats[M_BYC_A * plane_n + c], p.dt));
    *vx = __fadd_rn(*vx, ac_velocity_increment(
        e_px, p.mats[M_BYC_B * plane_n + c], p.dt));
  }
}

// Recording (acoustic.ac_step's rec): data[s, :, r, it + 1] = (p, vx, vz) at
// receiver r, on the row or at its point.
__global__ void ac_record_kernel(Params p, int it) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.S * p.n_rec) return;
  const int s = idx / p.n_rec;
  const int r = idx % p.n_rec;
  const size_t c =
      p.rec_z == nullptr
          ? static_cast<size_t>(p.rec_row) * p.nx + p.rec_x0 + r
          : static_cast<size_t>(p.rec_z[r]) * p.nx + p.rec_x[r];
  const size_t ch = static_cast<size_t>(p.n_rec) * p.nt;
  float* out = p.data + static_cast<size_t>(s) * kAcFields * ch +
               static_cast<size_t>(r) * p.nt + it + 1;
  out[0] = plane(p, F_P, s)[c];
  out[ch] = plane(p, F_VX_AC, s)[c];
  out[2 * ch] = plane(p, F_VZ_AC, s)[c];
}

}  // namespace

// Runs all nt-1 steps for all shots on `stream`; returns the first CUDA
// error (0 on success).  Does not synchronise and allocates nothing: the
// caller passes a zeroed state and a zeroed data buffer, and either a strip
// buffer of (S, nt-1, 3, 2 n_bnd (nz + nx)) floats, which every step fills,
// or null.  Receivers: either a row (rec_z null; rec_row, rec_x0) or n_rec
// points (rec_z, rec_x), validated by the caller.  Three launches a step.
extern "C" int acoustic_forward(const float* mats, const float* prof_z,
                                const float* prof_x, const float* stf,
                                const int* src_z, const int* src_x,
                                const int* rec_z, const int* rec_x,
                                float* state, float* data, float* strips,
                                int S, int nz, int nx, int nt, int rec_row,
                                int rec_x0, int n_rec, int npml, int n_bnd,
                                float dt, float src_amp, void* stream) {
  Params p{mats, prof_z, prof_x, stf, src_z, src_x, rec_z, rec_x, state,
           data, strips, S, nz, nx, nt, rec_row, rec_x0, n_rec, dt, src_amp,
           strip_geom(nz, nx, npml, n_bnd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kBlockX, kBlockZ, 1);
  const dim3 grid((nx + kBlockX - 1) / kBlockX, (nz + kBlockZ - 1) / kBlockZ,
                  S);
  const int rec_blocks = (S * n_rec + kRecThreads - 1) / kRecThreads;
  for (int it = 0; it < nt - 1; ++it) {
    ac_pressure_kernel<<<grid, block, 0, st>>>(p, it);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ac_velocity_kernel<<<grid, block, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ac_record_kernel<<<rec_blocks, kRecThreads, 0, st>>>(p, it);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
