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
// One fused launch a step (ac_fwd_step_kernel), recording included.
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
// Recording inside the step, as in elastic_fwd.cu.  Data index k is the
// state after step k-1, which is what launch k copies into shared memory
// (buffer k % 2, which no block writes in that launch): p on the tile and
// its 2-cell halo, vz and vx on the tile and its 4-cell halo.  So launch it
// records index it (it >= 1; index 0 stays the zeroed buffer's 0), and after
// the loop one more launch of the same kernel in record-only mode (load,
// record, return) records index nt-1: nt launches a forward.  The record
// pass runs after the first cp.async group has arrived and before the
// pressure loop updates p in place in shared memory, and ends with a
// __syncthreads() only in a tile that holds receivers, a condition that is
// uniform over the block.  A receiver row needs no table (the tile whose
// z-range holds the row records the receivers of its x-range); points come
// with the per-plan table by tile of the elastic forward
// (cuda_engine._tile_table), in receiver order within a tile, so a cell
// visited twice gives each receiver its own sample; acoustic_forward refuses
// a table built for other tiles than kTileZ x kTileX.  A sample is a copy
// of three values (ac_record_sample), so the data are the plain version's
// bits.  TMA and tensor cores are not used, for the reasons given in
// elastic_fwd.cu.
//
// Rounding: the stencils, the interior increments and the source use the
// shared code of elastic_common.cuh and acoustic_common.cuh, with explicit
// rounding, so that the backward kernel's reconstruction subtracts exactly
// what this kernel adds.

#include "acoustic_common.cuh"

namespace {

using namespace acoustic;

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
  const int* tile_ptr;  // (n_tiles + 1,) receiver points by tile, or null
  const int* tile_rec;  // (R,) receiver indices, grouped by tile
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

// The receivers that the tile at (z0, x0) records at data index it: their
// number (0 when it < 1, where index 0 stays the zeroed buffer's 0), and in
// *first the first receiver's x (a row) or the first entry of the tile's
// run in tile_rec (points).  Uniform over the block.
__device__ __forceinline__ int tile_receivers(const Params& p, int it,
                                              int z0, int x0, int* first) {
  if (it < 1 || p.n_rec < 1) return 0;
  if (p.rec_z == nullptr) {
    if (p.rec_row < z0 || p.rec_row >= z0 + TZ) return 0;
    const int lo = max(x0, p.rec_x0), hi = min(x0 + TX, p.rec_x0 + p.n_rec);
    *first = lo;
    return max(0, hi - lo);
  }
  const int t = blockIdx.y * gridDim.x + blockIdx.x;
  *first = p.tile_ptr[t];
  return p.tile_ptr[t + 1] - *first;
}

// The sample of receiver r of shot s at data index it (acoustic.ac_step's
// rec): (pr = p, vx, vz) at its cell, from the shared copies of the state
// this launch reads: t is the cell on the 2-cell halo of p, v on the 4-cell
// halo of vz and vx.
__device__ __forceinline__ void ac_record_sample(const Params& p,
                                                 const float* s_p,
                                                 const float* s_vz,
                                                 const float* s_vx, int t,
                                                 int v, int s, int r,
                                                 int it) {
  const size_t ch = static_cast<size_t>(p.n_rec) * p.nt;
  float* out = p.data + static_cast<size_t>(s) * kAcFields * ch +
               static_cast<size_t>(r) * p.nt + it;
  out[0] = s_p[t];
  out[ch] = s_vx[v];
  out[2 * ch] = s_vz[v];
}

// One step it for a tile of one shot: the recording of data index it from
// the state the step reads, the pressure half-step and the source
// (acoustic.ac_step, first half) on the tile and a 2-cell halo, the velocity
// half-step on the tile.  Reads buffer cur, writes buffer cur ^ 1.  Every
// value it reads comes into shared memory by cp.async at the top, in two
// groups: the first phase (and the recording) waits for its own inputs, and
// the second phase's arrive while it runs.  With record_only (the launch
// after the last step) it records and returns; a block with no receivers
// returns at once.
__global__ void __launch_bounds__(kTileThreads, 4)
ac_fwd_step_kernel(Params p, int it, int cur, bool record_only) {
  __shared__ float sm[kAcFwdShared];
  const int s = blockIdx.z;
  const int z0 = blockIdx.y * TZ, x0 = blockIdx.x * TX;
  int rec_first = 0;
  const int n_here = tile_receivers(p, it, z0, x0, &rec_first);
  if (record_only && n_here == 0) return;
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

  // recording, before the pressure loop updates s_p in place
  if (n_here > 0) {
    for (int j = threadIdx.x; j < n_here; j += kTileThreads) {
      int r, z, x;
      if (p.rec_z == nullptr) {
        x = rec_first + j;
        z = p.rec_row;
        r = x - p.rec_x0;
      } else {
        r = p.tile_rec[rec_first + j];
        z = p.rec_z[r];
        x = p.rec_x[r];
      }
      const int lz = z - z0, lx = x - x0;
      ac_record_sample(p, s_p, s_vz, s_vx, (lz + 2) * SX + lx + 2,
                       (lz + 4) * LX + lx + 4, s, r, it);
    }
    if (record_only) {
      cp_async_wait_group<0>();  // no copy in flight when the block exits
      return;
    }
    __syncthreads();
  }

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
// either a row (rec_z null; rec_row, rec_x0) or n_rec points (rec_z, rec_x)
// with their table by tile (tile_ptr, tile_rec), built for tile_z x tile_x
// tiles, validated by the caller; tiles other than the kernel's return
// kErrTileMismatch before any launch.  nt launches for nt >= 2 (none
// below): nt-1 fused steps, each recording the state it reads, and the
// record-only launch of index nt-1.
extern "C" int acoustic_forward(const float* mats, const float* prof_z,
                                const float* prof_x, const float* stf,
                                const int* src_z, const int* src_x,
                                const int* rec_z, const int* rec_x,
                                const int* tile_ptr, const int* tile_rec,
                                float* fields, float* psi, float* data,
                                float* strips, int S, int nz, int nx, int nt,
                                int rec_row, int rec_x0, int n_rec,
                                int tile_z, int tile_x, int npml, int n_bnd,
                                int band_z_lo, int band_z_hi, int band_x_lo,
                                int band_x_hi, float dt, float src_amp,
                                void* stream) {
  if (tile_z != kTileZ || tile_x != kTileX) return kErrTileMismatch;
  if (nt < 2) return 0;  // the zeroed data: nothing to step or record
  Params p{mats, prof_z, prof_x, stf, src_z, src_x, rec_z, rec_x, tile_ptr,
           tile_rec, fields, psi, data, strips, S, nz, nx, nt, rec_row,
           rec_x0, n_rec, dt, src_amp, strip_geom(nz, nx, npml, n_bnd),
           Band{band_z_lo, band_z_hi}, Band{band_x_lo, band_x_hi}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((nx + TX - 1) / TX, (nz + TZ - 1) / TZ, S);
  for (int it = 0; it < nt; ++it) {
    // launch nt-1 records index nt-1 and steps no further
    ac_fwd_step_kernel<<<grid, kTileThreads, 0, st>>>(p, it, it & 1,
                                                      it == nt - 1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
