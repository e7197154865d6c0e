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
// them).  Counting each input once and each output once (the strips too),
// the work is operation-bound (1.9 ms of FP32 peak at the reference
// workload); what a kernel pays instead is its traffic to L2 and device
// memory.  The design cuts that traffic:
//
// One fused launch a step (fwd_step_kernel), recording included.  A
// block owns a kTileZ x kTileX tile of one shot.  At its top it copies
// every value the step reads into shared memory by cp.async (a cell off the
// grid, or a memory off its band, is filled with 0, the edge rule): vz and
// vx of the tile and a 4-cell halo; the stresses, three material planes
// and the stress phase's memories on the tile and a 2-cell halo; then, as
// a second group that arrives while the stress phase runs, the buoyancies
// and the velocity phase's memories on the tile.  So a block waits for
// device memory about once a step, not once a dependent load.
// It then runs the stress half-step on the tile and the 2-cell halo, in
// place in shared memory, and the velocity half-step on the tile from those
// stresses.  The halo's stresses are recomputed by every block that needs
// them, from the same inputs and with the same code, so they are the bits
// their owner writes; only the owner of a cell writes it to device memory.
// The source is added wherever its cell is computed.  Interior traffic is
// about 15 plane values a cell-step (5 fields read and written, 5 material
// planes) and the CPML memories in their bands.
//
// Double buffers.  Inside one launch a block reads its neighbours' vz, vx,
// stresses and stress-phase CPML memories, which their owners update in
// the same launch; so the fields live twice, (2, 5, S, nz, nx), and step it
// reads buffer it % 2 and writes the other (the final fields are in buffer
// (nt-1) % 2), and so do the stress phase's 4 memories.  The velocity
// phase's 4 memories are read and written only by the owner of their cell
// and live once.
//
// CPML memory only in its bands.  Outside the rows (z-memories) or columns
// (x-memories) where the profile's a is not 0, psi <- b psi + a d stays 0
// and the derivative is d ik; there the kernel neither reads nor writes a
// memory and takes __fmul_rn(d, ik), the value cpml_deriv returns with a
// zero memory.  The memories are stored in band storage (Band,
// elastic_common.cuh): z-memories (S, nbz, nx), x-memories (S, nz, nbx),
// 2 npml rows or columns each at the usual profiles.
//
// Why cp.async and not TMA: a TMA tensor map needs every global row pitch
// to be a multiple of 16 bytes, and the reference grid is 265 cells wide
// (1060 bytes), so the planes would need a padded pitch that the strips, the
// final fields and the plain versions do not share; and a block owns one
// tile, so there is no next tile whose loads could overlap this one's
// compute.  cp.async with src-size 0 gives the same zero fill at the edge.
// Tensor cores do not apply: the step is FP32 stencil arithmetic with
// explicit rounding (below), which TF32 would break.
//
// Strips: with a strip buffer, the owner of a strip cell writes the 5
// fields' values before the step (libCUFD.cu:272, propagator._save_bnd),
// from the loaded vz/vx and the stresses it reads before updating them; no
// extra launch.
//
// Recording inside the step.  Data index k is the state after step k-1,
// which is exactly what launch k copies into shared memory (buffer k % 2,
// which no block writes in that launch).  So launch it records index it
// (it >= 1; index 0 is the zeroed buffer's 0, left unwritten, since a
// weighted sample of the zero state could round to -0.0), and after the
// loop one more launch of the same kernel in record-only mode (load,
// record, return) records index nt-1: nt launches a forward.
// The ett sample reads neighbours (x-1, z-1; x+1, z+1 for the weighted
// strain) that the 4-cell halo of vz and vx holds, and a neighbour off the
// grid is the copy's zero fill, at()'s rule.  The record pass runs after
// the first cp.async group has arrived and before the stress loop updates
// the stresses in place in shared memory, and ends with a __syncthreads()
// only in a tile that holds receivers, a condition that is uniform over
// the block, so blocks without receivers pay nothing but the test.  One
// __device__ function, record_sample, computes every sample, in the
// rounding order of the plain version.
//
// Which block records which receiver.  A receiver row needs no table: the
// block whose z-range holds the row records the receivers of its x-range.
// Points (K1-fiber) come with a per-plan table in compressed-row form by
// tile (cuda_engine._tile_table): tile_ptr (n_tiles + 1), then receiver
// indices in receiver order within a tile, so a cell visited twice gives
// each receiver its own sample.  The table is built for kTileZ x kTileX
// tiles, and elastic_forward refuses one built for other sizes.  The TPU
// kernel records full-width rows by a masked sublane reduction against K
// per-lane row maps, because Mosaic cannot gather; a CUDA thread can read
// its receiver's (z, x), so the K layers, row maps and lane weights are not
// carried over, and a column of receivers (the TPU package's transposed
// plan) is just such a table.  The work is R receivers x 4 samples a step.
//
// Illumination (rtm --physics elastic): with an illumination buffer the
// owner of a cell adds (szz + sxx)^2 of the step's new stresses, source
// included, to its cell (imaging.source_illumination; the velocity phase
// does not touch the stresses), rounded as the plain loop rounds it
// (pr = szz + sxx; ill += pr * pr), and elastic_illumination runs the fused
// step alone, one launch a step, recording nothing.  Without the buffer the
// step's arithmetic is unchanged.
//
// Rounding: the stencils, the interior increments and the source use the
// shared code of elastic_common.cuh, with explicit rounding, so that the
// backward kernel's reconstruction subtracts exactly what this kernel adds.

#include "elastic_common.cuh"

namespace {

using namespace elastic;

constexpr int TZ = kTileZ, TX = kTileX;
// vz and vx with a 4-cell halo; the stresses after the stress half-step
// on the tile and a 2-cell halo
constexpr int LZ = kHalo4Z, LX = kHalo4X;
constexpr int SZ = kHalo2Z, SX = kHalo2X;

// CPML memories in band storage: 6 z-memory planes (S, nbz, nx), then 6
// x-memory planes (S, nz, nbx).  The stress phase's (P_VZ_DZ, P_VX_DZ;
// P_VX_DX, P_VZ_DX) take two planes each, buffer b at index + b.
enum PsiZ { PZ_VZ_DZ = 0, PZ_VX_DZ = 2, PZ_SZZ_DZ = 4, PZ_SXZ_DZ = 5 };
enum PsiX { PX_VX_DX = 0, PX_VZ_DX = 2, PX_SXZ_DX = 4, PX_SXX_DX = 5 };
constexpr int kPsiPlanes = 6;  // of each axis

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
  const int* tile_ptr;  // (n_tiles + 1,) receiver points by tile, or null
  const int* tile_rec;  // (R,) receiver indices, grouped by tile
  float* fields;        // (2, 5, S, nz, nx)
  float* psi;           // band storage, see PsiZ / PsiX
  float* data;          // (S, 4, R, nt)
  float* strips;        // (S, nt-1, 5, strip n), or null
  float* ill;           // (S, nz, nx) illumination sums, or null
  int S, nz, nx, nt;
  int rec_row, rec_x0, n_rec, ett_mode;
  float dt, src_amp;    // src_amp = src_scale * dt
  float inv_dz, inv_dx;
  StripGeom sg;
  Band bz, bx;
};

__device__ __forceinline__ float* field(const Params& p, int buf, int k,
                                        int s) {
  return p.fields + plane_offset(buf * kNumFields + k, s, p.S, p.nz, p.nx);
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

// Shared memory of fwd_step_kernel, offsets in floats: vz, vx with the
// 4-cell halo; on the tile and a 2-cell halo the stresses (updated in place
// to their values after the stress half-step), lam, lp2m, ave_mu, and the
// stress phase's memories (z: P_VZ_DZ, P_VX_DZ; x: P_VX_DX, P_VZ_DX) of
// buffer cur; on the tile byc_a, byc_b and the velocity phase's memories
// (z: P_SZZ_DZ, P_SXZ_DZ; x: P_SXZ_DX, P_SXX_DX).  A memory off its band,
// like any cell off the grid, is copied in as 0 and never read.
constexpr int S_V = 0;
constexpr int S_S = S_V + 2 * kH4;
constexpr int S_M = S_S + 3 * kH2;
constexpr int S_PS = S_M + 3 * kH2;
constexpr int S_B = S_PS + 4 * kH2;
constexpr int S_PV = S_B + 2 * kT;
static_assert(S_PV + 4 * kT == kFwdShared, "kFwdShared counts this layout");

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

// The sample of receiver r of shot s at data index it
// (propagator._record, exx, ezz or weighted), from the shared copies of the
// state this launch reads: v is the receiver's cell on the 4-cell halo of
// vz and vx, t on the 2-cell halo of the stresses.  pr = szz + sxx; ett is
// vx[c] - vx[c-1] or vz[c] - vz[c-nx], not divided by the spacing
// (recording_exx / recording_ezz), or the weighted strain rounded step by
// step in the plain version's order, (w0 exx + w1 exz) + w2 ezz, each
// strain a difference times the reciprocal spacing.  The x-shifted samples
// stay on the receiver's own row.
__device__ __forceinline__ void record_sample(const Params& p,
                                              const float* s_vz,
                                              const float* s_vx,
                                              const float* s_szz,
                                              const float* s_sxx, int v,
                                              int t, int s, int r, int it) {
  const float vz_c = s_vz[v], vx_c = s_vx[v];
  const float pr = __fadd_rn(s_szz[t], s_sxx[t]);
  const float d_xx = __fsub_rn(vx_c, s_vx[v - 1]);
  const float d_zz = __fsub_rn(vz_c, s_vz[v - LX]);
  float ett;
  if (p.ett_mode == ETT_EXX) {
    ett = d_xx;
  } else if (p.ett_mode == ETT_EZZ) {
    ett = d_zz;
  } else {
    const float* w = p.rec_w + 3 * static_cast<size_t>(r);
    const float exx = __fmul_rn(d_xx, p.inv_dx);
    const float ezz = __fmul_rn(d_zz, p.inv_dz);
    const float exz = __fmul_rn(0.5f, __fadd_rn(
        __fmul_rn(__fsub_rn(s_vx[v + LX], vx_c), p.inv_dz),
        __fmul_rn(__fsub_rn(s_vz[v + 1], vz_c), p.inv_dx)));
    ett = __fadd_rn(__fadd_rn(__fmul_rn(w[0], exx), __fmul_rn(w[1], exz)),
                    __fmul_rn(w[2], ezz));
  }
  const size_t ch = static_cast<size_t>(p.n_rec) * p.nt;
  float* out = p.data + static_cast<size_t>(s) * 4 * ch +
               static_cast<size_t>(r) * p.nt + it;
  out[0] = pr;
  out[ch] = vx_c;
  out[2 * ch] = vz_c;
  out[3 * ch] = ett;
}

// One step it for a tile of one shot: the recording of data index it
// from the state the step reads, the stress half-step
// (propagator._stress_update + _add_source) on the tile and a 2-cell halo,
// the velocity half-step (propagator._velocity_update) on the tile.  Reads
// buffer cur, writes buffer cur ^ 1.  Every value it reads comes into
// shared memory by cp.async at the top, in two groups: the first phase
// (and the recording) waits for its own inputs, and the second phase's
// arrive while it runs.  With record_only (the launch after the last step)
// it records and returns; a block with no receivers returns at once.
__global__ void __launch_bounds__(kTileThreads, 3)
fwd_step_kernel(Params p, int it, int cur, bool record_only) {
  __shared__ float sm[kFwdShared];
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
    cp_async_f32(&sm[S_V + i], field(p, cur, F_VZ, s) + c, on);
    cp_async_f32(&sm[S_V + kH4 + i], field(p, cur, F_VX, s) + c, on);
  }
  for (int i = threadIdx.x; i < kH2; i += kTileThreads) {
    const int z = z0 - 2 + i / SX, x = x0 - 2 + i % SX;
    const bool on = z >= 0 && z < nz && x >= 0 && x < nx;
    const size_t c = on ? static_cast<size_t>(z) * nx + x : 0;
    cp_async_f32(&sm[S_S + i], field(p, cur, F_SZZ, s) + c, on);
    cp_async_f32(&sm[S_S + kH2 + i], field(p, cur, F_SXX, s) + c, on);
    cp_async_f32(&sm[S_S + 2 * kH2 + i], field(p, cur, F_SXZ, s) + c, on);
    cp_async_f32(&sm[S_M + i], p.mats + LAM * plane_n + c, on);
    cp_async_f32(&sm[S_M + kH2 + i], p.mats + LP2M * plane_n + c, on);
    cp_async_f32(&sm[S_M + 2 * kH2 + i], p.mats + AVE_MU * plane_n + c, on);
    const bool bz = on && in_band(p.bz, z), bx = on && in_band(p.bx, x);
    cp_async_f32(&sm[S_PS + i],
                 bz ? psi_z(p, PZ_VZ_DZ + cur, s, z, x) : any, bz);
    cp_async_f32(&sm[S_PS + kH2 + i],
                 bz ? psi_z(p, PZ_VX_DZ + cur, s, z, x) : any, bz);
    cp_async_f32(&sm[S_PS + 2 * kH2 + i],
                 bx ? psi_x(p, PX_VX_DX + cur, s, z, x) : any, bx);
    cp_async_f32(&sm[S_PS + 3 * kH2 + i],
                 bx ? psi_x(p, PX_VZ_DX + cur, s, z, x) : any, bx);
  }
  // the first phase's inputs are one group, the second phase's another,
  // which arrives while the first phase runs
  cp_async_commit();
  for (int j = threadIdx.x; j < kT; j += kTileThreads) {
    const int z = z0 + j / TX, x = x0 + j % TX;
    const bool on = z < nz && x < nx;
    const size_t c = on ? static_cast<size_t>(z) * nx + x : 0;
    cp_async_f32(&sm[S_B + j], p.mats + BYC_A * plane_n + c, on);
    cp_async_f32(&sm[S_B + kT + j], p.mats + BYC_B * plane_n + c, on);
    const bool bz = on && in_band(p.bz, z), bx = on && in_band(p.bx, x);
    cp_async_f32(&sm[S_PV + j], bz ? psi_z(p, PZ_SZZ_DZ, s, z, x) : any,
                 bz);
    cp_async_f32(&sm[S_PV + kT + j],
                 bz ? psi_z(p, PZ_SXZ_DZ, s, z, x) : any, bz);
    cp_async_f32(&sm[S_PV + 2 * kT + j],
                 bx ? psi_x(p, PX_SXZ_DX, s, z, x) : any, bx);
    cp_async_f32(&sm[S_PV + 3 * kT + j],
                 bx ? psi_x(p, PX_SXX_DX, s, z, x) : any, bx);
  }
  cp_async_commit();
  cp_async_wait_group<1>();
  __syncthreads();

  const float* s_vz = sm + S_V;
  const float* s_vx = sm + S_V + kH4;
  float* s_szz = sm + S_S;
  float* s_sxx = sm + S_S + kH2;
  float* s_sxz = sm + S_S + 2 * kH2;

  // recording, before the stress loop updates s_szz and s_sxx in place
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
      record_sample(p, s_vz, s_vx, s_szz, s_sxx, (lz + 4) * LX + lx + 4,
                    (lz + 2) * SX + lx + 2, s, r, it);
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
    float szz = s_szz[i], sxx = s_sxx[i], sxz = s_sxz[i];

    if (own && p.strips != nullptr) {
      int slot[2];
      const int n_slots = strip_slots(p.sg, z, x, nz, nx, slot);
      if (n_slots > 0) {
        const float vals[kNumFields] = {s_vz[v], s_vx[v], szz, sxx, sxz};
        float* out = p.strips + strip_offset(p.sg, s, it, p.nt);
        for (int k = 0; k < n_slots; ++k) {
          for (int f = 0; f < kNumFields; ++f) {
            out[static_cast<size_t>(f) * p.sg.n + slot[k]] = vals[f];
          }
        }
      }
    }

    const float d_vz_dz = tile_dz_minus<LX>(s_vz, v);
    const float d_vx_dx = tile_dx_minus<LX>(s_vx, v);
    const float d_vx_dz = tile_dz_plus<LX>(s_vx, v);
    const float d_vz_dx = tile_dx_plus<LX>(s_vz, v);
    float e_vz_dz, e_vx_dz, e_vx_dx, e_vz_dx;
    if (in_band(p.bz, z)) {
      float m0, m1;
      e_vz_dz = cpml_deriv_to(d_vz_dz, pz[IK * nz + z], pz[A * nz + z],
                              pz[B * nz + z], sm[S_PS + i], &m0);
      e_vx_dz = cpml_deriv_to(d_vx_dz, pz[IK_H * nz + z], pz[A_H * nz + z],
                              pz[B_H * nz + z], sm[S_PS + kH2 + i], &m1);
      if (own) {
        *psi_z(p, PZ_VZ_DZ + nxt, s, z, x) = m0;
        *psi_z(p, PZ_VX_DZ + nxt, s, z, x) = m1;
      }
    } else {
      e_vz_dz = __fmul_rn(d_vz_dz, pz[IK * nz + z]);
      e_vx_dz = __fmul_rn(d_vx_dz, pz[IK_H * nz + z]);
    }
    if (in_band(p.bx, x)) {
      float m0, m1;
      e_vx_dx = cpml_deriv_to(d_vx_dx, px[IK * nx + x], px[A * nx + x],
                              px[B * nx + x], sm[S_PS + 2 * kH2 + i], &m0);
      e_vz_dx = cpml_deriv_to(d_vz_dx, px[IK_H * nx + x], px[A_H * nx + x],
                              px[B_H * nx + x], sm[S_PS + 3 * kH2 + i], &m1);
      if (own) {
        *psi_x(p, PX_VX_DX + nxt, s, z, x) = m0;
        *psi_x(p, PX_VZ_DX + nxt, s, z, x) = m1;
      }
    } else {
      e_vx_dx = __fmul_rn(d_vx_dx, px[IK * nx + x]);
      e_vz_dx = __fmul_rn(d_vz_dx, px[IK_H * nx + x]);
    }

    if (in_update_mask(z, x, nz, nx)) {
      const StressInc inc = stress_increment(
          e_vz_dz, e_vx_dx, e_vx_dz, e_vz_dx, sm[S_M + i], sm[S_M + kH2 + i],
          sm[S_M + 2 * kH2 + i], p.dt);
      szz = __fadd_rn(szz, inc.zz);
      sxx = __fadd_rn(sxx, inc.xx);
      sxz = __fadd_rn(sxz, inc.xz);
    }
    if (z == src_z && x == src_x) {
      const float amp = source_amp(p.stf, s, it, p.nt, p.src_amp);
      szz = __fadd_rn(szz, amp);
      sxx = __fadd_rn(sxx, __fmul_rn(p.rxz[s], amp));
    }
    s_szz[i] = szz;
    s_sxx[i] = sxx;
    s_sxz[i] = sxz;
    if (own) {
      field(p, nxt, F_SZZ, s)[c] = szz;
      field(p, nxt, F_SXX, s)[c] = sxx;
      field(p, nxt, F_SXZ, s)[c] = sxz;
      if (p.ill != nullptr) {
        const float pr = __fadd_rn(szz, sxx);
        float* ill = p.ill + s * plane_n + c;
        *ill = __fadd_rn(*ill, __fmul_rn(pr, pr));
      }
    }
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
    const float d_szz_dz = tile_dz_plus<SX>(s_szz, t);
    const float d_sxz_dx = tile_dx_minus<SX>(s_sxz, t);
    const float d_sxz_dz = tile_dz_minus<SX>(s_sxz, t);
    const float d_sxx_dx = tile_dx_plus<SX>(s_sxx, t);
    float e_szz_dz, e_sxz_dz, e_sxz_dx, e_sxx_dx;
    if (in_band(p.bz, z)) {
      float m0 = sm[S_PV + j], m1 = sm[S_PV + kT + j];
      e_szz_dz = cpml_deriv(d_szz_dz, pz[IK_H * nz + z], pz[A_H * nz + z],
                            pz[B_H * nz + z], &m0);
      e_sxz_dz = cpml_deriv(d_sxz_dz, pz[IK * nz + z], pz[A * nz + z],
                            pz[B * nz + z], &m1);
      *psi_z(p, PZ_SZZ_DZ, s, z, x) = m0;
      *psi_z(p, PZ_SXZ_DZ, s, z, x) = m1;
    } else {
      e_szz_dz = __fmul_rn(d_szz_dz, pz[IK_H * nz + z]);
      e_sxz_dz = __fmul_rn(d_sxz_dz, pz[IK * nz + z]);
    }
    if (in_band(p.bx, x)) {
      float m0 = sm[S_PV + 2 * kT + j], m1 = sm[S_PV + 3 * kT + j];
      e_sxz_dx = cpml_deriv(d_sxz_dx, px[IK * nx + x], px[A * nx + x],
                            px[B * nx + x], &m0);
      e_sxx_dx = cpml_deriv(d_sxx_dx, px[IK_H * nx + x], px[A_H * nx + x],
                            px[B_H * nx + x], &m1);
      *psi_x(p, PX_SXZ_DX, s, z, x) = m0;
      *psi_x(p, PX_SXX_DX, s, z, x) = m1;
    } else {
      e_sxz_dx = __fmul_rn(d_sxz_dx, px[IK * nx + x]);
      e_sxx_dx = __fmul_rn(d_sxx_dx, px[IK_H * nx + x]);
    }

    float vz = s_vz[v], vx = s_vx[v];
    if (in_update_mask(z, x, nz, nx)) {
      vz = __fadd_rn(vz, velocity_increment(e_szz_dz, e_sxz_dx, sm[S_B + j],
                                            p.dt));
      vx = __fadd_rn(vx, velocity_increment(e_sxz_dz, e_sxx_dx,
                                            sm[S_B + kT + j], p.dt));
    }
    field(p, nxt, F_VZ, s)[c] = vz;
    field(p, nxt, F_VX, s)[c] = vx;
  }
}

}  // namespace

// The tile plan, as chip_smoke.py reports it: kTileZ, kTileX, kTileThreads,
// and the shared memory of fwd_step_kernel (static) and of elastic_bwd.cu's
// bwd_step_kernel (dynamic) in bytes.
extern "C" void elastic_tile_plan(int* out) {
  out[0] = kTileZ;
  out[1] = kTileX;
  out[2] = kTileThreads;
  out[3] = static_cast<int>(kFwdShared * sizeof(float));
  out[4] = static_cast<int>(kBwdShared * sizeof(float));
}

// The blocks of fwd_step_kernel that one SM of this device holds at once,
// into out[0]; returns the CUDA error (0 on success).
extern "C" int elastic_forward_plan(int* out) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], fwd_step_kernel, kTileThreads, 0));
}

// Runs all nt-1 steps for all shots on `stream`, and records at every
// index; returns the first CUDA error (0 on success).  Does not synchronise
// and allocates nothing: the caller passes zeroed fields (2, 5, S, nz, nx),
// the final fields come back in buffer (nt-1) % 2; zeroed CPML memories in
// band storage, 6 z-memory planes (S, nbz, nx) then 6 x-memory planes
// (S, nz, nbx) with nbz and nbx the band sizes of [band_z_lo, band_z_hi)
// and [band_x_lo, band_x_hi); a zeroed data buffer; and either a strip
// buffer of (S, nt-1, 5, 2 n_bnd (nz + nx)) floats, which every step
// fills, or null.  Receivers: either a row (rec_z null; rec_row, rec_x0) or
// n_rec points (rec_z, rec_x and, for ETT_WEIGHTED, rec_w) with their
// table by tile (tile_ptr, tile_rec), built for tile_z x tile_x tiles,
// validated by the caller; tiles other than the kernel's return
// kErrTileMismatch before any launch.  nt launches for nt >= 2 (none
// below): nt-1 fused steps, each recording the state it reads, and the
// record-only launch of index nt-1.  Snapshots: with save_every > 0,
// after the step that ends at time (k + 1) save_every, a copy of that
// state's buffer (5, S, nz, nx) into snaps[k], on the same stream, for
// every such time up to nt-1 (snaps holds (nt-1) / save_every of them);
// with snaps null or save_every 0 nothing is copied.
extern "C" int elastic_forward(const float* mats, const float* prof_z,
                               const float* prof_x, const float* stf,
                               const int* src_z, const int* src_x,
                               const float* rxz, const int* rec_z,
                               const int* rec_x, const float* rec_w,
                               const int* tile_ptr, const int* tile_rec,
                               float* fields, float* psi, float* data,
                               float* strips, float* snaps, int save_every,
                               int S, int nz, int nx, int nt,
                               int rec_row, int rec_x0, int n_rec,
                               int ett_mode, int tile_z, int tile_x,
                               int npml, int n_bnd, int band_z_lo,
                               int band_z_hi, int band_x_lo, int band_x_hi,
                               float dt, float src_amp, float inv_dz,
                               float inv_dx, void* stream) {
  if (tile_z != kTileZ || tile_x != kTileX) return kErrTileMismatch;
  if (nt < 2) return 0;  // the zeroed data: nothing to step or record
  Params p{mats, prof_z, prof_x, stf, src_z, src_x, rxz, rec_z, rec_x, rec_w,
           tile_ptr, tile_rec, fields, psi, data, strips, nullptr, S, nz,
           nx, nt, rec_row, rec_x0, n_rec, ett_mode, dt, src_amp, inv_dz,
           inv_dx, strip_geom(nz, nx, npml, n_bnd),
           Band{band_z_lo, band_z_hi}, Band{band_x_lo, band_x_hi}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((nx + TX - 1) / TX, (nz + TZ - 1) / TZ, S);
  const size_t state_n = static_cast<size_t>(kNumFields) * S * nz * nx;
  for (int it = 0; it < nt; ++it) {
    // launch nt-1 records index nt-1 and steps no further
    fwd_step_kernel<<<grid, kTileThreads, 0, st>>>(p, it, it & 1,
                                                   it == nt - 1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // the state after it + 1 steps lies in buffer (it + 1) & 1 until the
    // launch after next overwrites it; the copy is ordered before that
    const int t = it + 1;
    if (snaps != nullptr && save_every > 0 && t < nt &&
        t % save_every == 0) {
      err = cudaMemcpyAsync(snaps + (t / save_every - 1) * state_n,
                            fields + (t & 1) * state_n,
                            state_n * sizeof(float),
                            cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

// The illumination of every shot (imaging.source_illumination): all nt-1
// steps of the fused step for all shots on `stream`, each owner adding its
// cell's (szz + sxx)^2 after the step to `ill` (S, nz, nx), which arrives
// zeroed; no recording, no strips, one launch a step.  `fields` and `psi`
// as for elastic_forward (zeroed; the final fields come back in buffer
// (nt-1) % 2).  Returns the first CUDA error (0 on success).
extern "C" int elastic_illumination(const float* mats, const float* prof_z,
                                    const float* prof_x, const float* stf,
                                    const int* src_z, const int* src_x,
                                    const float* rxz, float* fields,
                                    float* psi, float* ill, int S, int nz,
                                    int nx, int nt, int band_z_lo,
                                    int band_z_hi, int band_x_lo,
                                    int band_x_hi, float dt, float src_amp,
                                    void* stream) {
  Params p{mats, prof_z, prof_x, stf, src_z, src_x, rxz, nullptr, nullptr,
           nullptr, nullptr, nullptr, fields, psi, nullptr, nullptr, ill, S,
           nz, nx, nt, 0, 0, 0, ETT_EXX, dt, src_amp, 0.0f, 0.0f,
           StripGeom{}, Band{band_z_lo, band_z_hi},
           Band{band_x_lo, band_x_hi}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((nx + TX - 1) / TX, (nz + TZ - 1) / TZ, S);
  for (int it = 0; it < nt - 1; ++it) {
    fwd_step_kernel<<<grid, kTileThreads, 0, st>>>(p, it, it & 1, false);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Message for an error code returned by elastic_forward,
// elastic_backward or acoustic_forward.
extern "C" const char* elastic_error_string(int err) {
  if (err == kErrTileMismatch) {
    return "the receiver table was built for other tiles than the kernel's "
           "kTileZ x kTileX";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
