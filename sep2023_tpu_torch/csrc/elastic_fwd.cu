// Elastic forward modeling on Hopper: nt-1 leapfrog steps of the O(4)
// staggered velocity-stress scheme with division-free CPML, an explosive
// point source and recording of (pr, vx, vz, ett) on a receiver row or at
// arbitrary receiver points, for all shots, and optionally the boundary
// strips of every step for the gradient.
//
// Replaces sep2023_tpu/ops/pallas_engine.py::_run_forward (the K1 Pallas
// kernel, pallas_call at line 875, body _fwd_body/_step_values/_record_rows),
// with save_strips False (forward modeling) and True (the gradient's
// forward, _pp_fwd), for a RowSurvey and for a FiberSurvey (K1-fiber).  At
// grids past the TPU's VMEM range the JAX package runs the same physics as
// pallas_stream.py::_make_fwd_megastep (K3, pallas_call at line 1243); all
// state here lives in device memory at any grid size, so this file is K3's
// counterpart too.  It computes what K1 computes; it does not copy K1's
// TPU layout (no 128-lane padding, no cyclic rolls, no VMEM ring, no DMA
// chunking, no lr/tb strip staging, no z-tiles, no ghost steps).  A stencil
// neighbour outside the grid reads as 0, the zero-padded edge of ops/fd.py;
// inside the update mask [2, n-3] both edge rules give the same values.
//
// What bounds it on this card: each cell-step does 102 FP32 operations
// (8 stencils, 8 CPML recursions, the increments; chip_smoke.py counts
// them) and touches about 36 f32 values across the two phases (5 fields,
// 8 psi, 5 material planes, stencil neighbours mostly from L1/L2).
// Counting each input once and each output once (the strips too), the work
// is operation-bound (1.9 ms of FP32 peak at the reference workload); one
// thread per cell with all operands from L1/L2 and device memory, as here,
// is bound by the memory traffic instead.  At the
// reference workload (165x265 padded grid, 19 shots) the state of all
// shots, 13 planes x 165 x 265 x 4 B x 19 = 43 MB, is close to the 50 MB L2.
// This first version is one thread per cell, three launches per step;
// shared-memory tiles with halos, temporal blocking, a persistent kernel and
// CUDA graphs are later work.
//
// Strips: with a strip buffer, the stress launch of step it writes the
// pre-update values of the 5 fields at every strip cell (libCUFD.cu:272,
// propagator._save_bnd): each thread writes its own cell's szz/sxx/sxz
// before updating them and its vz/vx, which no thread writes in that launch,
// so there is no race and no extra launch.  The final fields are the first
// 5 planes of the state buffer, so no copy is made after the loop.
//
// Recording is its own launch: the ett sample vx[r,x] - vx[r,x-1] is taken
// on the post-update field, and a neighbour's new vx is not visible inside
// the launch that writes it.
//
// Point recording (K1-fiber).  The TPU kernel records full-width rows by a
// masked sublane reduction against K per-lane row maps, because Mosaic
// cannot gather; a CUDA thread can, so record_points_kernel is one thread
// per (shot, receiver) that reads its own (z, x) from a table, and the K
// layers, row maps and lane weights are not carried over.  A column of
// receivers (the TPU package's transposed plan) is just such a table.  The
// work is R receivers x 4 samples a step, bound by the launch, not by bytes
// or operations.
//
// Rounding: the stencils, the interior increments and the source use the
// shared code of elastic_common.cuh, with explicit rounding, so that the
// backward kernel's reconstruction subtracts exactly what this kernel adds.

#include "elastic_common.cuh"

namespace {

using namespace elastic;

constexpr int kRecThreads = 128;

// Plane order of the state buffer (13, S, nz, nx): the 5 fields (Field
// order), then the 8 CPML psi.
enum Psi {
  P_VZ_DZ = 5, P_VX_DX, P_VX_DZ, P_VZ_DX,
  P_SZZ_DZ, P_SXZ_DX, P_SXZ_DZ, P_SXX_DX,
};

struct Params {
  const float* mats;    // (5, nz, nx)
  const float* prof_z;  // (6, nz)
  const float* prof_x;  // (6, nx)
  const float* stf;     // (S, nt)
  const int* src_z;     // (S,)
  const int* src_x;     // (S,)
  const float* rxz;     // (S,)
  const int* rec_z;     // (R,) receiver points, or null for a receiver row
  const int* rec_x;     // (R,)
  const float* rec_w;   // (R, 3) weights of (exx, exz, ezz), for ETT_WEIGHTED
  float* state;         // (13, S, nz, nx)
  float* data;          // (S, 4, R, nt)
  float* strips;        // (S, nt-1, 5, strip n), or null
  int S, nz, nx, nt;
  int rec_row, rec_x0, n_rec, ett_mode;
  float dt, src_amp;    // src_amp = src_scale * dt
  float inv_dz, inv_dx;
  StripGeom sg;
};

__device__ __forceinline__ float* plane(const Params& p, int k, int s) {
  return p.state + plane_offset(k, s, p.S, p.nz, p.nx);
}

// Stress half-step (propagator._stress_update + _add_source): 4 velocity-
// derivative psi everywhere, szz/sxx/sxz under the mask, then the source.
__global__ void stress_kernel(Params p, int it) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (x >= p.nx || z >= p.nz) return;
  const int nz = p.nz, nx = p.nx;
  const size_t c = static_cast<size_t>(z) * nx + x;
  const size_t plane_n = static_cast<size_t>(nz) * nx;
  const float* vz = plane(p, F_VZ, s);
  const float* vx = plane(p, F_VX, s);
  const float* pz = p.prof_z;
  const float* px = p.prof_x;
  float* szz = plane(p, F_SZZ, s) + c;
  float* sxx = plane(p, F_SXX, s) + c;
  float* sxz = plane(p, F_SXZ, s) + c;

  if (p.strips != nullptr) {
    int slot[2];
    const int n_slots = strip_slots(p.sg, z, x, nz, nx, slot);
    if (n_slots > 0) {
      const float vals[kNumFields] = {vz[c], vx[c], *szz, *sxx, *sxz};
      float* out = p.strips + strip_offset(p.sg, s, it, p.nt);
      for (int k = 0; k < n_slots; ++k) {
        for (int f = 0; f < kNumFields; ++f) {
          out[static_cast<size_t>(f) * p.sg.n + slot[k]] = vals[f];
        }
      }
    }
  }

  const float e_vz_dz = cpml_deriv(
      dz_minus(vz, z, x, nz, nx), pz[IK * nz + z], pz[A * nz + z],
      pz[B * nz + z], plane(p, P_VZ_DZ, s) + c);
  const float e_vx_dx = cpml_deriv(
      dx_minus(vx, z, x, nz, nx), px[IK * nx + x], px[A * nx + x],
      px[B * nx + x], plane(p, P_VX_DX, s) + c);
  const float e_vx_dz = cpml_deriv(
      dz_plus(vx, z, x, nz, nx), pz[IK_H * nz + z], pz[A_H * nz + z],
      pz[B_H * nz + z], plane(p, P_VX_DZ, s) + c);
  const float e_vz_dx = cpml_deriv(
      dx_plus(vz, z, x, nz, nx), px[IK_H * nx + x], px[A_H * nx + x],
      px[B_H * nx + x], plane(p, P_VZ_DX, s) + c);

  if (z >= 2 && z <= nz - 3 && x >= 2 && x <= nx - 3) {
    const StressInc inc = stress_increment(e_vz_dz, e_vx_dx, e_vx_dz,
                                           e_vz_dx, p.mats, plane_n, c, p.dt);
    *szz = __fadd_rn(*szz, inc.zz);
    *sxx = __fadd_rn(*sxx, inc.xx);
    *sxz = __fadd_rn(*sxz, inc.xz);
  }
  if (z == p.src_z[s] && x == p.src_x[s]) {
    const float amp = source_amp(p.stf, s, it, p.nt, p.src_amp);
    *szz = __fadd_rn(*szz, amp);
    *sxx = __fadd_rn(*sxx, __fmul_rn(p.rxz[s], amp));
  }
}

// Velocity half-step (propagator._velocity_update) on the new stresses.
__global__ void velocity_kernel(Params p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (x >= p.nx || z >= p.nz) return;
  const int nz = p.nz, nx = p.nx;
  const size_t c = static_cast<size_t>(z) * nx + x;
  const size_t plane_n = static_cast<size_t>(nz) * nx;
  const float* szz = plane(p, F_SZZ, s);
  const float* sxx = plane(p, F_SXX, s);
  const float* sxz = plane(p, F_SXZ, s);
  const float* pz = p.prof_z;
  const float* px = p.prof_x;

  const float e_szz_dz = cpml_deriv(
      dz_plus(szz, z, x, nz, nx), pz[IK_H * nz + z], pz[A_H * nz + z],
      pz[B_H * nz + z], plane(p, P_SZZ_DZ, s) + c);
  const float e_sxz_dx = cpml_deriv(
      dx_minus(sxz, z, x, nz, nx), px[IK * nx + x], px[A * nx + x],
      px[B * nx + x], plane(p, P_SXZ_DX, s) + c);
  const float e_sxz_dz = cpml_deriv(
      dz_minus(sxz, z, x, nz, nx), pz[IK * nz + z], pz[A * nz + z],
      pz[B * nz + z], plane(p, P_SXZ_DZ, s) + c);
  const float e_sxx_dx = cpml_deriv(
      dx_plus(sxx, z, x, nz, nx), px[IK_H * nx + x], px[A_H * nx + x],
      px[B_H * nx + x], plane(p, P_SXX_DX, s) + c);

  if (z >= 2 && z <= nz - 3 && x >= 2 && x <= nx - 3) {
    float* vz = plane(p, F_VZ, s) + c;
    float* vx = plane(p, F_VX, s) + c;
    *vz = __fadd_rn(*vz, velocity_increment(e_szz_dz, e_sxz_dx,
                                            p.mats[BYC_A * plane_n + c],
                                            p.dt));
    *vx = __fadd_rn(*vx, velocity_increment(e_sxz_dz, e_sxx_dx,
                                            p.mats[BYC_B * plane_n + c],
                                            p.dt));
  }
}

// Row recording (propagator._record, exx or ezz): data[s, :, r, it + 1].
__global__ void record_kernel(Params p, int it) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.S * p.n_rec) return;
  const int s = idx / p.n_rec;
  const int r = idx % p.n_rec;
  const int nx = p.nx;
  const size_t c = static_cast<size_t>(p.rec_row) * nx + p.rec_x0 + r;
  const float* vz = plane(p, F_VZ, s);
  const float* vx = plane(p, F_VX, s);
  const float pr = plane(p, F_SZZ, s)[c] + plane(p, F_SXX, s)[c];
  // ett is not divided by the spacing (recording_exx / recording_ezz)
  const float ett = p.ett_mode == ETT_EZZ ? vz[c] - vz[c - nx]
                                          : vx[c] - vx[c - 1];
  const size_t ch = static_cast<size_t>(p.n_rec) * p.nt;
  float* out = p.data + static_cast<size_t>(s) * 4 * ch +
               static_cast<size_t>(r) * p.nt + it + 1;
  out[0] = pr;
  out[ch] = vx[c];
  out[2 * ch] = vz[c];
  out[3 * ch] = ett;
}

// Point recording (propagator._record at arbitrary receivers, exx, ezz or
// weighted): data[s, :, r, it + 1], one thread per (shot, receiver).  The
// x-shifted sample stays on the receiver's own row.  A neighbour outside
// the grid reads as 0; the wrapper keeps every receiver inside
// 1 <= z <= nz-2, 0 <= x < nx.  The weighted sample is rounded step by step
// in the plain version's order: (w0 exx + w1 exz) + w2 ezz, each strain a
// difference times the reciprocal spacing.
__global__ void record_points_kernel(Params p, int it) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.S * p.n_rec) return;
  const int s = idx / p.n_rec;
  const int r = idx % p.n_rec;
  const int nz = p.nz, nx = p.nx;
  const int z = p.rec_z[r], x = p.rec_x[r];
  const size_t c = static_cast<size_t>(z) * nx + x;
  const float* vz = plane(p, F_VZ, s);
  const float* vx = plane(p, F_VX, s);
  const float vz_c = vz[c], vx_c = vx[c];
  const float pr = plane(p, F_SZZ, s)[c] + plane(p, F_SXX, s)[c];
  const float d_xx = __fsub_rn(vx_c, at(vx, z, x - 1, nz, nx));
  const float d_zz = __fsub_rn(vz_c, at(vz, z - 1, x, nz, nx));
  float ett;
  if (p.ett_mode == ETT_EXX) {
    ett = d_xx;  // not divided by the spacing (recording_exx)
  } else if (p.ett_mode == ETT_EZZ) {
    ett = d_zz;
  } else {
    const float* w = p.rec_w + 3 * static_cast<size_t>(r);
    const float exx = __fmul_rn(d_xx, p.inv_dx);
    const float ezz = __fmul_rn(d_zz, p.inv_dz);
    const float exz = __fmul_rn(0.5f, __fadd_rn(
        __fmul_rn(__fsub_rn(at(vx, z + 1, x, nz, nx), vx_c), p.inv_dz),
        __fmul_rn(__fsub_rn(at(vz, z, x + 1, nz, nx), vz_c), p.inv_dx)));
    ett = __fadd_rn(__fadd_rn(__fmul_rn(w[0], exx), __fmul_rn(w[1], exz)),
                    __fmul_rn(w[2], ezz));
  }
  const size_t ch = static_cast<size_t>(p.n_rec) * p.nt;
  float* out = p.data + static_cast<size_t>(s) * 4 * ch +
               static_cast<size_t>(r) * p.nt + it + 1;
  out[0] = pr;
  out[ch] = vx_c;
  out[2 * ch] = vz_c;
  out[3 * ch] = ett;
}

}  // namespace

// Runs all nt-1 steps for all shots on `stream`; returns the first CUDA
// error (0 on success).  Does not synchronise and allocates nothing: the
// caller passes a zeroed state and a zeroed data buffer, and either a strip
// buffer of (S, nt-1, 5, 2 n_bnd (nz + nx)) floats, which every step fills,
// or null.  Receivers: either a row (rec_z null; rec_row, rec_x0) or n_rec
// points (rec_z, rec_x and, for ETT_WEIGHTED, rec_w), validated by the
// caller.  Three launches a step either way.
extern "C" int elastic_forward(const float* mats, const float* prof_z,
                               const float* prof_x, const float* stf,
                               const int* src_z, const int* src_x,
                               const float* rxz, const int* rec_z,
                               const int* rec_x, const float* rec_w,
                               float* state, float* data, float* strips,
                               int S, int nz, int nx, int nt, int rec_row,
                               int rec_x0, int n_rec, int ett_mode, int npml,
                               int n_bnd, float dt, float src_amp,
                               float inv_dz, float inv_dx, void* stream) {
  Params p{mats, prof_z, prof_x, stf, src_z, src_x, rxz, rec_z, rec_x, rec_w,
           state, data, strips, S, nz, nx, nt, rec_row, rec_x0, n_rec,
           ett_mode, dt, src_amp, inv_dz, inv_dx,
           strip_geom(nz, nx, npml, n_bnd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kBlockX, kBlockZ, 1);
  const dim3 grid((nx + kBlockX - 1) / kBlockX, (nz + kBlockZ - 1) / kBlockZ,
                  S);
  const int rec_blocks = (S * n_rec + kRecThreads - 1) / kRecThreads;
  for (int it = 0; it < nt - 1; ++it) {
    stress_kernel<<<grid, block, 0, st>>>(p, it);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    velocity_kernel<<<grid, block, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (rec_z == nullptr) {
      record_kernel<<<rec_blocks, kRecThreads, 0, st>>>(p, it);
    } else {
      record_points_kernel<<<rec_blocks, kRecThreads, 0, st>>>(p, it);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Message for an error code returned by elastic_forward or
// elastic_backward.
extern "C" const char* elastic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
