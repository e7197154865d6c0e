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
// What bounds it on this card: 50 FP32 operations per cell-step (4
// stencils, 4 CPML recursions, the increments; chip_smoke.py counts them).
// Counting each input once and each output once it is operation-bound with
// and without strips (the strips of a step are 2 n_bnd (nz + nx) values a
// field, far fewer than the cells); what a kernel pays instead is its
// traffic to L2 and device memory and the latency of each step's chain of
// loads.  The design is elastic_fwd.cu's, on half the planes:
//
// One fused launch a step (ac_fwd_step_kernel), then the record launch.
// Pressure first: a block owns a kTileZ x kTileX tile of one shot.  At its
// top it copies every value the step reads into shared memory by cp.async
// (a cell off the grid, or a memory off its band, is filled with 0, the
// edge rule): vz and vx of the tile and a 4-cell halo; p, lam and the
// pressure phase's two memories on the tile and a 2-cell halo; then, as a
// second group that arrives while the pressure phase runs, the buoyancies
// and the velocity phase's two memories on the tile.  It then runs the
// pressure half-step and the source on the tile and the 2-cell halo, in
// place in shared memory, and the velocity half-step on the tile from that
// new, post-source p.  The halo's pressure is recomputed by every block
// that needs it, from the same inputs and with the same code, so it is the
// bits its owner writes; only the owner of a cell writes it to device
// memory.  The source is added wherever its cell is computed.  Interior
// traffic is about 9 plane values a cell-step (3 fields read and written,
// 3 material planes) and the CPML memories in their bands; 27,392 bytes of
// static shared memory a block (kAcFwdShared), so registers set the blocks
// an SM (__launch_bounds__ asks for 4; 5 or 6 blocks an SM, with 48 or 40
// registers, took the same time at the reference workload).
//
// Double buffers.  Inside one launch a block reads its neighbours' p, vz,
// vx and pressure-phase CPML memories, which their owners update in the
// same launch; so the fields live twice, (2, 3, S, nz, nx), and step it
// reads buffer it % 2 and writes the other (the final fields are in buffer
// (nt-1) % 2), and so do the pressure phase's 2 memories.  The velocity
// phase's 2 memories are read and written only by the owner of their cell
// and live once.
//
// CPML memory only in its bands.  Outside the rows (z-memories) or columns
// (x-memories) where the profile's a is not 0, psi <- b psi + a d stays 0
// and the derivative is d ik; there the kernel neither reads nor writes a
// memory and takes __fmul_rn(d, ik), the value cpml_deriv returns with a
// zero memory.  The memories are stored in band storage (Band,
// elastic_common.cuh): z-memories (S, nbz, nx), x-memories (S, nz, nbx).
//
// Strips: with a strip buffer, the owner of a strip cell writes the three
// fields' values before the step (acoustic._save_bnd) from what it loaded;
// no extra launch.
//
// Recording is its own launch: a sample reads the fields the step wrote,
// and a cell's owner is one block of many; points (which may visit a cell
// twice) and a row run the same launch.  TMA and tensor cores are not used,
// for the reasons given in elastic_fwd.cu.
//
// Rounding: the stencils, the interior increments and the source use the
// shared code of elastic_common.cuh and acoustic_common.cuh, with explicit
// rounding, so that the backward kernel's reconstruction subtracts exactly
// what this kernel adds.

#include "acoustic_common.cuh"

namespace {

using namespace acoustic;

constexpr int kRecThreads = 128;

constexpr int TZ = kTileZ, TX = kTileX;
// vz and vx with a 4-cell halo; p after the pressure half-step on the tile
// and a 2-cell halo
constexpr int LX = kHalo4X;
constexpr int SX = kHalo2X;

// CPML memories in band storage: 3 z-memory planes (S, nbz, nx), then 3
// x-memory planes (S, nz, nbx).  The pressure phase's (PZ_VZ_DZ; PX_VX_DX)
// take two planes each, buffer b at index + b.
enum PsiZ { PZ_VZ_DZ = 0, PZ_P_DZ = 2 };
enum PsiX { PX_VX_DX = 0, PX_P_DX = 2 };
constexpr int kPsiPlanes = 3;  // of each axis

struct Params {
  const float* mats;    // (3, nz, nx): lam, byc_a, byc_b
  const float* prof_z;  // (6, nz)
  const float* prof_x;  // (6, nx)
  const float* stf;     // (S, nt)
  const int* src_z;     // (S,)
  const int* src_x;     // (S,)
  const int* rec_z;     // (R,) receiver points, or null for a receiver row
  const int* rec_x;     // (R,)
  float* fields;        // (2, 3, S, nz, nx)
  float* psi;           // band storage, see PsiZ / PsiX
  float* data;          // (S, 3, R, nt)
  float* strips;        // (S, nt-1, 3, strip n), or null
  int S, nz, nx, nt;
  int rec_row, rec_x0, n_rec;
  float dt, src_amp;    // src_amp = src_scale * dt
  StripGeom sg;
  Band bz, bx;
};

__device__ __forceinline__ float* field(const Params& p, int buf, int k,
                                        int s) {
  return p.fields + plane_offset(buf * kAcFields + k, s, p.S, p.nz, p.nx);
}

// z-memory plane k of shot s at (z, x), z in the band
__device__ __forceinline__ float* psi_z(const Params& p, int k, int s, int z,
                                        int x) {
  const size_t nb = band_size(p.bz, p.nz);
  return p.psi + (static_cast<size_t>(k) * p.S + s) * nb * p.nx +
         static_cast<size_t>(band_index(p.bz, z)) * p.nx + x;
}

// x-memory plane k of shot s at (z, x), x in the band
__device__ __forceinline__ float* psi_x(const Params& p, int k, int s, int z,
                                        int x) {
  const size_t nbz = band_size(p.bz, p.nz), nbx = band_size(p.bx, p.nx);
  return p.psi + kPsiPlanes * static_cast<size_t>(p.S) * nbz * p.nx +
         (static_cast<size_t>(k) * p.S + s) * p.nz * nbx +
         static_cast<size_t>(z) * nbx + band_index(p.bx, x);
}

// Shared memory of ac_fwd_step_kernel, offsets in floats: vz, vx with the
// 4-cell halo; on the tile and a 2-cell halo p (updated in place to its
// value after the pressure half-step and the source), lam, and the pressure
// phase's memories (z: P_VZ_DZ; x: P_VX_DX) of buffer cur; on the tile
// byc_a, byc_b and the velocity phase's memories (z: P_P_DZ; x: P_P_DX).  A
// memory off its band, like any cell off the grid, is copied in as 0 and
// never read.
constexpr int S_V = 0;
constexpr int S_P = S_V + 2 * kH4;
constexpr int S_LAM = S_P + kH2;
constexpr int S_PS = S_LAM + kH2;
constexpr int S_B = S_PS + 2 * kH2;
constexpr int S_PV = S_B + 2 * kT;
static_assert(S_PV + 2 * kT == kAcFwdShared,
              "kAcFwdShared counts this layout");

// One step it for a tile of one shot: the pressure half-step and the source
// (acoustic.ac_step, first half) on the tile and a 2-cell halo, the velocity
// half-step on the tile.  Reads buffer cur, writes buffer cur ^ 1.  Every
// value it reads comes into shared memory by cp.async at the top, in two
// groups: the first phase waits for its own inputs, and the second phase's
// arrive while it runs.
__global__ void __launch_bounds__(kTileThreads, 4)
ac_fwd_step_kernel(Params p, int it, int cur) {
  __shared__ float sm[kAcFwdShared];
  const int s = blockIdx.z;
  const int z0 = blockIdx.y * TZ, x0 = blockIdx.x * TX;
  const int nz = p.nz, nx = p.nx;
  const int nxt = cur ^ 1;
  const size_t plane_n = static_cast<size_t>(nz) * nx;
  const float* pz = p.prof_z;
  const float* px = p.prof_x;
  const float* any = p.mats;  // a valid address for the copies that read 0

  for (int i = threadIdx.x; i < kH4; i += kTileThreads) {
    const int z = z0 - 4 + i / LX, x = x0 - 4 + i % LX;
    const bool on = z >= 0 && z < nz && x >= 0 && x < nx;
    const size_t c = on ? static_cast<size_t>(z) * nx + x : 0;
    cp_async_f32(&sm[S_V + i], field(p, cur, F_VZ_AC, s) + c, on);
    cp_async_f32(&sm[S_V + kH4 + i], field(p, cur, F_VX_AC, s) + c, on);
  }
  for (int i = threadIdx.x; i < kH2; i += kTileThreads) {
    const int z = z0 - 2 + i / SX, x = x0 - 2 + i % SX;
    const bool on = z >= 0 && z < nz && x >= 0 && x < nx;
    const size_t c = on ? static_cast<size_t>(z) * nx + x : 0;
    cp_async_f32(&sm[S_P + i], field(p, cur, F_P, s) + c, on);
    cp_async_f32(&sm[S_LAM + i], p.mats + M_LAM * plane_n + c, on);
    const bool bz = on && in_band(p.bz, z), bx = on && in_band(p.bx, x);
    cp_async_f32(&sm[S_PS + i],
                 bz ? psi_z(p, PZ_VZ_DZ + cur, s, z, x) : any, bz);
    cp_async_f32(&sm[S_PS + kH2 + i],
                 bx ? psi_x(p, PX_VX_DX + cur, s, z, x) : any, bx);
  }
  // the first phase's inputs are one group, the second phase's another,
  // which arrives while the first phase runs
  cp_async_commit();
  for (int j = threadIdx.x; j < kT; j += kTileThreads) {
    const int z = z0 + j / TX, x = x0 + j % TX;
    const bool on = z < nz && x < nx;
    const size_t c = on ? static_cast<size_t>(z) * nx + x : 0;
    cp_async_f32(&sm[S_B + j], p.mats + M_BYC_A * plane_n + c, on);
    cp_async_f32(&sm[S_B + kT + j], p.mats + M_BYC_B * plane_n + c, on);
    const bool bz = on && in_band(p.bz, z), bx = on && in_band(p.bx, x);
    cp_async_f32(&sm[S_PV + j], bz ? psi_z(p, PZ_P_DZ, s, z, x) : any, bz);
    cp_async_f32(&sm[S_PV + kT + j], bx ? psi_x(p, PX_P_DX, s, z, x) : any,
                 bx);
  }
  cp_async_commit();
  cp_async_wait_group<1>();
  __syncthreads();

  const float* s_vz = sm + S_V;
  const float* s_vx = sm + S_V + kH4;
  float* s_p = sm + S_P;
  const int src_z = p.src_z[s], src_x = p.src_x[s];
#pragma unroll 1
  for (int i = threadIdx.x; i < kH2; i += kTileThreads) {
    const int lz = i / SX, lx = i % SX;
    const int z = z0 - 2 + lz, x = x0 - 2 + lx;
    if (z < 0 || z >= nz || x < 0 || x >= nx) continue;  // stays 0
    const bool own = lz >= 2 && lz < 2 + TZ && lx >= 2 && lx < 2 + TX;
    const int v = (lz + 2) * LX + lx + 2;
    const size_t c = static_cast<size_t>(z) * nx + x;
    float pr = s_p[i];

    if (own && p.strips != nullptr) {
      int slot[2];
      const int n_slots = strip_slots(p.sg, z, x, nz, nx, slot);
      if (n_slots > 0) {
        const float vals[kAcFields] = {pr, s_vz[v], s_vx[v]};
        float* out = p.strips + strip_offset(p.sg, s, it, p.nt, kAcFields);
        for (int k = 0; k < n_slots; ++k) {
          for (int f = 0; f < kAcFields; ++f) {
            out[static_cast<size_t>(f) * p.sg.n + slot[k]] = vals[f];
          }
        }
      }
    }

    const float d_vz = tile_dz_plus<LX>(s_vz, v);
    const float d_vx = tile_dx_minus<LX>(s_vx, v);
    float e_vz, e_vx;
    if (in_band(p.bz, z)) {
      float m;
      e_vz = cpml_deriv_to(d_vz, pz[IK_H * nz + z], pz[A_H * nz + z],
                           pz[B_H * nz + z], sm[S_PS + i], &m);
      if (own) *psi_z(p, PZ_VZ_DZ + nxt, s, z, x) = m;
    } else {
      e_vz = __fmul_rn(d_vz, pz[IK_H * nz + z]);
    }
    if (in_band(p.bx, x)) {
      float m;
      e_vx = cpml_deriv_to(d_vx, px[IK * nx + x], px[A * nx + x],
                           px[B * nx + x], sm[S_PS + kH2 + i], &m);
      if (own) *psi_x(p, PX_VX_DX + nxt, s, z, x) = m;
    } else {
      e_vx = __fmul_rn(d_vx, px[IK * nx + x]);
    }

    if (in_update_mask(z, x, nz, nx)) {
      pr = __fadd_rn(pr, pressure_increment(e_vz, e_vx, sm[S_LAM + i],
                                            p.dt));
    }
    if (z == src_z && x == src_x) {
      pr = __fadd_rn(pr, source_amp(p.stf, s, it, p.nt, p.src_amp));
    }
    s_p[i] = pr;
    if (own) field(p, nxt, F_P, s)[c] = pr;
  }
  cp_async_wait_group<0>();  // the second phase's inputs
  __syncthreads();

#pragma unroll 1
  for (int j = threadIdx.x; j < kT; j += kTileThreads) {
    const int lz = j / TX, lx = j % TX;
    const int z = z0 + lz, x = x0 + lx;
    if (z >= nz || x >= nx) continue;
    const int t = (lz + 2) * SX + lx + 2;
    const int v = (lz + 4) * LX + lx + 4;
    const size_t c = static_cast<size_t>(z) * nx + x;
    const float d_pz = tile_dz_minus<SX>(s_p, t);
    const float d_px = tile_dx_plus<SX>(s_p, t);
    float e_pz, e_px;
    if (in_band(p.bz, z)) {
      float m = sm[S_PV + j];
      e_pz = cpml_deriv(d_pz, pz[IK * nz + z], pz[A * nz + z],
                        pz[B * nz + z], &m);
      *psi_z(p, PZ_P_DZ, s, z, x) = m;
    } else {
      e_pz = __fmul_rn(d_pz, pz[IK * nz + z]);
    }
    if (in_band(p.bx, x)) {
      float m = sm[S_PV + kT + j];
      e_px = cpml_deriv(d_px, px[IK_H * nx + x], px[A_H * nx + x],
                        px[B_H * nx + x], &m);
      *psi_x(p, PX_P_DX, s, z, x) = m;
    } else {
      e_px = __fmul_rn(d_px, px[IK_H * nx + x]);
    }

    float vz = s_vz[v], vx = s_vx[v];
    if (in_update_mask(z, x, nz, nx)) {
      vz = __fadd_rn(vz, ac_velocity_increment(e_pz, sm[S_B + j], p.dt));
      vx = __fadd_rn(vx, ac_velocity_increment(e_px, sm[S_B + kT + j],
                                               p.dt));
    }
    field(p, nxt, F_VZ_AC, s)[c] = vz;
    field(p, nxt, F_VX_AC, s)[c] = vx;
  }
}

// Recording (acoustic.ac_step's rec) of the fields in buffer buf:
// data[s, :, r, it + 1] = (p, vx, vz) at receiver r, on the row or at its
// point.
__global__ void ac_record_kernel(Params p, int it, int buf) {
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
  out[0] = field(p, buf, F_P, s)[c];
  out[ch] = field(p, buf, F_VX_AC, s)[c];
  out[2 * ch] = field(p, buf, F_VZ_AC, s)[c];
}

}  // namespace

// The fused forward's plan, as chip_smoke.py reports it: its static shared
// memory a block in bytes, and the blocks of it an SM of the current device
// holds at once (registers and shared memory together).  Returns the CUDA
// error of the occupancy query.
extern "C" int acoustic_forward_plan(int* out) {
  out[0] = static_cast<int>(kAcFwdShared * sizeof(float));
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], ac_fwd_step_kernel, kTileThreads, 0));
}

// Runs all nt-1 steps for all shots on `stream`; returns the first CUDA
// error (0 on success).  Does not synchronise and allocates nothing: the
// caller passes zeroed fields (2, 3, S, nz, nx), the final fields come back
// in buffer (nt-1) % 2; zeroed CPML memories in band storage, 3 z-memory
// planes (S, nbz, nx) then 3 x-memory planes (S, nz, nbx) with nbz and nbx
// the band sizes of [band_z_lo, band_z_hi) and [band_x_lo, band_x_hi); a
// zeroed data buffer; and either a strip buffer of (S, nt-1, 3,
// 2 n_bnd (nz + nx)) floats, which every step fills, or null.  Receivers:
// either a row (rec_z null; rec_row, rec_x0) or n_rec points (rec_z,
// rec_x), validated by the caller.  Two launches a step: the fused step and
// the record.
extern "C" int acoustic_forward(const float* mats, const float* prof_z,
                                const float* prof_x, const float* stf,
                                const int* src_z, const int* src_x,
                                const int* rec_z, const int* rec_x,
                                float* fields, float* psi, float* data,
                                float* strips, int S, int nz, int nx, int nt,
                                int rec_row, int rec_x0, int n_rec, int npml,
                                int n_bnd, int band_z_lo, int band_z_hi,
                                int band_x_lo, int band_x_hi, float dt,
                                float src_amp, void* stream) {
  Params p{mats, prof_z, prof_x, stf, src_z, src_x, rec_z, rec_x, fields,
           psi, data, strips, S, nz, nx, nt, rec_row, rec_x0, n_rec, dt,
           src_amp, strip_geom(nz, nx, npml, n_bnd),
           Band{band_z_lo, band_z_hi}, Band{band_x_lo, band_x_hi}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((nx + TX - 1) / TX, (nz + TZ - 1) / TZ, S);
  const int rec_blocks = (S * n_rec + kRecThreads - 1) / kRecThreads;
  for (int it = 0; it < nt - 1; ++it) {
    const int cur = it & 1;
    ac_fwd_step_kernel<<<grid, kTileThreads, 0, st>>>(p, it, cur);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ac_record_kernel<<<rec_blocks, kRecThreads, 0, st>>>(p, it, cur ^ 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
