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
// One fused launch a step (fwd_step_kernel), then the record launch.  A
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
// Recording is its own launch: the ett sample vx[r,x] - vx[r,x-1] is taken
// on the post-update field, a neighbour's value that another block writes.
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

constexpr int kRecThreads = 128;

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

// One step it for a tile of one shot: the stress half-step
// (propagator._stress_update + _add_source) on the tile and a 2-cell halo,
// the velocity half-step (propagator._velocity_update) on the tile.  Reads
// buffer cur, writes buffer cur ^ 1.  Every value it reads comes into
// shared memory by cp.async at the top, in two groups: the first phase
// waits for its own inputs, and the second phase's arrive while it runs.
__global__ void __launch_bounds__(kTileThreads, 3)
fwd_step_kernel(Params p, int it, int cur) {
  __shared__ float sm[kFwdShared];
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

// Row recording (propagator._record, exx or ezz) of the fields in buffer
// buf: data[s, :, r, it + 1].
__global__ void record_kernel(Params p, int it, int buf) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.S * p.n_rec) return;
  const int s = idx / p.n_rec;
  const int r = idx % p.n_rec;
  const int nx = p.nx;
  const size_t c = static_cast<size_t>(p.rec_row) * nx + p.rec_x0 + r;
  const float* vz = field(p, buf, F_VZ, s);
  const float* vx = field(p, buf, F_VX, s);
  const float pr = field(p, buf, F_SZZ, s)[c] + field(p, buf, F_SXX, s)[c];
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
// weighted) of the fields in buffer buf: data[s, :, r, it + 1], one thread
// per (shot, receiver).  The x-shifted sample stays on the receiver's own
// row.  A neighbour outside the grid reads as 0; the wrapper keeps every
// receiver inside 1 <= z <= nz-2, 0 <= x < nx.  The weighted sample is
// rounded step by step in the plain version's order: (w0 exx + w1 exz) +
// w2 ezz, each strain a difference times the reciprocal spacing.
__global__ void record_points_kernel(Params p, int it, int buf) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.S * p.n_rec) return;
  const int s = idx / p.n_rec;
  const int r = idx % p.n_rec;
  const int nz = p.nz, nx = p.nx;
  const int z = p.rec_z[r], x = p.rec_x[r];
  const size_t c = static_cast<size_t>(z) * nx + x;
  const float* vz = field(p, buf, F_VZ, s);
  const float* vx = field(p, buf, F_VX, s);
  const float vz_c = vz[c], vx_c = vx[c];
  const float pr = field(p, buf, F_SZZ, s)[c] + field(p, buf, F_SXX, s)[c];
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

// Runs all nt-1 steps for all shots on `stream`; returns the first CUDA
// error (0 on success).  Does not synchronise and allocates nothing: the
// caller passes zeroed fields (2, 5, S, nz, nx), the final fields come back
// in buffer (nt-1) % 2; zeroed CPML memories in band storage, 6 z-memory
// planes (S, nbz, nx) then 6 x-memory planes (S, nz, nbx) with nbz and nbx
// the band sizes of [band_z_lo, band_z_hi) and [band_x_lo, band_x_hi); a
// zeroed data buffer; and either a strip buffer of (S, nt-1, 5,
// 2 n_bnd (nz + nx)) floats, which every step fills, or null.  Receivers:
// either a row (rec_z null; rec_row, rec_x0) or n_rec points (rec_z, rec_x
// and, for ETT_WEIGHTED, rec_w), validated by the caller.  Two launches a
// step either way: the fused step and the record.
extern "C" int elastic_forward(const float* mats, const float* prof_z,
                               const float* prof_x, const float* stf,
                               const int* src_z, const int* src_x,
                               const float* rxz, const int* rec_z,
                               const int* rec_x, const float* rec_w,
                               float* fields, float* psi, float* data,
                               float* strips, int S, int nz, int nx, int nt,
                               int rec_row, int rec_x0, int n_rec,
                               int ett_mode, int npml, int n_bnd,
                               int band_z_lo, int band_z_hi, int band_x_lo,
                               int band_x_hi, float dt, float src_amp,
                               float inv_dz, float inv_dx, void* stream) {
  Params p{mats, prof_z, prof_x, stf, src_z, src_x, rxz, rec_z, rec_x, rec_w,
           fields, psi, data, strips, nullptr, S, nz, nx, nt, rec_row,
           rec_x0, n_rec, ett_mode, dt, src_amp, inv_dz, inv_dx,
           strip_geom(nz, nx, npml, n_bnd), Band{band_z_lo, band_z_hi},
           Band{band_x_lo, band_x_hi}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((nx + TX - 1) / TX, (nz + TZ - 1) / TZ, S);
  const int rec_blocks = (S * n_rec + kRecThreads - 1) / kRecThreads;
  for (int it = 0; it < nt - 1; ++it) {
    const int cur = it & 1;
    fwd_step_kernel<<<grid, kTileThreads, 0, st>>>(p, it, cur);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (rec_z == nullptr) {
      record_kernel<<<rec_blocks, kRecThreads, 0, st>>>(p, it, cur ^ 1);
    } else {
      record_points_kernel<<<rec_blocks, kRecThreads, 0, st>>>(p, it,
                                                               cur ^ 1);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
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
           nullptr, fields, psi, nullptr, nullptr, ill, S, nz, nx, nt, 0, 0,
           0, ETT_EXX, dt, src_amp, 0.0f, 0.0f, StripGeom{},
           Band{band_z_lo, band_z_hi}, Band{band_x_lo, band_x_hi}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((nx + TX - 1) / TX, (nz + TZ - 1) / TZ, S);
  for (int it = 0; it < nt - 1; ++it) {
    fwd_step_kernel<<<grid, kTileThreads, 0, st>>>(p, it, it & 1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Message for an error code returned by elastic_forward or
// elastic_backward.
extern "C" const char* elastic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
