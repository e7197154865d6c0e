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
// before it undoes the pressure.  One fused launch a reverse step
// (ac_bwd_step_kernel).  A block owns a kTileZ x kTileX tile of one shot; a
// host loop steps it = nt-2 .. 0.
//   load: every value the step reads but the accumulators, into shared
//     memory by cp.async (0 off the grid and off a memory's band), so a
//     block waits for device memory about once a step: the carried p(t+1)
//     and the pressure phase's stencil cotangents D1, D2 of step it+1 on the
//     tile and a 4-cell halo, what the velocity phase reads at its own cell
//     on the tile and a 2-cell halo; then, as a second group that arrives
//     while the velocity phase runs, what the pressure phase reads at its
//     own cell, on the tile (46,860 bytes of static shared memory a block
//     with the point receivers' row sums, kAcBwdShared; __launch_bounds__
//     holds the registers to 64, so four blocks run on an SM, 6% faster
//     than three at the reference workload).  A phase reads a copied value
//     only after the wait for its group and a __syncthreads();
//   velocity phase, on the tile and a 2-cell halo: the cotangents of vz/vx
//     after step it (carried, plus D1/D2 transposed, plus the receivers'
//     cotangent), the stencils of the carried p(t+1), vz/vx rebuilt before
//     step it (interior increment subtracted inside the tight interior,
//     strips injected), the velocity half-step's adjoint: the two psi
//     recursions and the p-stencils' cotangents D3, D4, all into shared
//     memory; the owner of a cell writes its vz/vx, their cotangents, its
//     memories and its buoyancy gradients;
//   pressure phase, on the tile: the total cotangent of p after step it
//     (carried, plus D3/D4 transposed, plus the recorded p on a receiver
//     row), d_stf at the source cell, the stencils of the rebuilt vz/vx, the
//     pressure reconstruction (source subtracted, interior increment
//     subtracted, strips injected), the image and illumination when asked
//     for, then the pressure half-step's adjoint: the two psi recursions,
//     D1, D2 for the next step, the gradient of lam.
// D3 and D4 never reach device memory.  The halo's velocity phase is
// recomputed by every block that needs it, from the same inputs with the
// same code (a receiver row's cotangent included), and thrown away; only
// the owner of a cell writes it, and only the owner reads and writes its
// accumulators and d_stf.  After the loop one launch sums the per-shot
// accumulator planes over shots in a fixed order (ac_sum_shots_kernel, on
// the body it shares with elastic_bwd.cu in shot_sum.cuh).  Nothing is
// accumulated with atomics, so a second backward gives the same bits.
//
// Double buffers.  In one launch a block reads at its neighbours' cells the
// fields, the cotangents of vz/vx, D1, D2 and (in the halo's velocity
// phase) the velocity phase's two adjoint memories, which their owners
// write in the same launch; so these live twice and reverse step k
// (it = nt-2-k) reads buffer k % 2 and writes the other.  The fields are
// (2, 3, S, nz, nx), buffer 0 holding the final fields on entry; the fields
// rebuilt at t=0 come back in buffer (nt-1) % 2.  The cotangent of p and
// the pressure phase's adjoint memories are read and written only by the
// owner of their cell and live once.
//
// CPML memory only in its bands.  Outside the rows (z-memories) or columns
// (x-memories) where the profile's a is not 0, the adjoint recursion's
// carried cotangent never reaches a result (cpml_deriv_adj returns
// ge ik + a q with a = 0), so the kernel neither reads nor writes it there
// and takes ge ik.  The memories are in band storage (Band,
// elastic_common.cuh) like the forward's.
//
// The tight interior [npml+2, n-3-npml] (acoustic._consts) is where the
// reconstruction updates; the strips keep the elastic bounds and overlap
// its first and last cell, where they take precedence.  Like the TPU
// kernel, the velocity phase takes the stencils of the carried p(t+1);
// the plain adjoint recomputes them with zero CPML memory, so gradients
// differ within 2 cells of the tight interior's edge.
//
// Point receivers: as in elastic_bwd.cu, an injection table in
// compressed-row form (one row per touched (adjoint plane, cell); a sample
// reads no neighbour, so a row has one entry per receiver on its cell) and
// its rows by the tiles that add them (cuda_engine._injection_tiles with
// the acoustic planes, built for kTileZ x kTileX tiles; acoustic_backward
// refuses others).  The fused step adds a row's sum against the data
// cotangent of recording index it+1 (injection_sum, entries in table
// order) to its shared copy of the carried cotangent, carried + sum as one
// rounded add: a vz or vx row after the first cp.async group has arrived,
// in every tile whose velocity phase reads the row's cell (the tile and
// its 2-cell halo, up to four tiles, each with the owner's bits), a p row
// after the second group has arrived, in the owner's tile alone (the
// pressure phase reads the cotangent of p on its own cells).  Each thread
// sums its first row of the tile's runs, and finds where in shared memory
// it lands, while the block's copies are in flight; each pass ends with a
// __syncthreads() only in a tile with rows of its kind, a condition uniform
// over the block.  No atomics.  So a backward is (nt-1) + 1 launches for
// points as for a receiver row.
//
// What bounds it on this card: 105 FP32 operations per cell-step (102 in the
// imaging variant; chip_smoke.py counts them) and, counting each input once
// and each output once, the strips and the data cotangent read once:
// operation-bound.  What a kernel pays is its traffic and the latency of a
// step's chain: about 18 plane values a cell-step in the interior (fields,
// the cotangents of vz/vx, D1 and D2 read and written, the cotangent of p,
// 3 material planes, 3 accumulators read and written) and the halo
// reloads, mostly from L2.  TMA and tensor cores are not used, for the
// reasons given in elastic_fwd.cu.
//
// Reconstruction uses the increments of acoustic_common.cuh, the same code
// and rounding as the forward kernel.

#include "acoustic_common.cuh"
#include "shot_sum.cuh"

namespace {

using namespace acoustic;

constexpr int TZ = kTileZ, TX = kTileX;
constexpr int LX = kHalo4X;  // loaded, 4-cell halo
constexpr int VX = kHalo2X;  // velocity phase, 2-cell halo

// Plane order of the work buffer (9, S, nz, nx): the carried cotangent of p
// once, then the carried cotangents of vz and vx and the pressure phase's
// stencil cotangents D1, D2 twice each (buffer b at index + b).
enum Work { W_A_P = 0, W_A_VZ = 1, W_A_VX = 3, W_D1 = 5, W_D2 = 7 };

// The adjoint CPML memories in band storage: 3 z-memory planes (S, nbz, nx),
// then 3 x-memory planes (S, nz, nbx); the velocity phase's (psi3; psi4)
// twice each.  psi1, psi3 are the z-memories of vz_dz and p_dz, psi2, psi4
// the x-memories of vx_dx and p_dx (acoustic.AcPsi).
enum AdjPsiZ { Z_P1 = 0, Z_P3 = 1 };
enum AdjPsiX { X_P2 = 0, X_P4 = 1 };
constexpr int kPsiPlanes = 3;  // of each axis

// The adjoint planes the injection table names (cuda_engine._AC_A_P ..).
enum InjPlane { INJ_P = 0, INJ_VZ, INJ_VX };

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
  const int* inj_ptr;     // (n_rows + 1,) entry range of each row
  const int* inj_plane;   // (n_rows,) InjPlane
  const int* inj_cell;    // (n_rows,) z * nx + x
  const int* ent_rec;     // (n_ent,) receiver
  const int* ent_ch;      // (n_ent,) channel 0..2
  const float* ent_coef;  // (n_ent,)
  // and its rows by tile: tile t's vz/vx rows (its tile and 2-cell halo) are
  // tile_inj[tile_ptr[2t] : tile_ptr[2t+1]], its p rows (its tile)
  // tile_inj[tile_ptr[2t+1] : tile_ptr[2t+2]], each run in table order
  const int* tile_ptr;    // (2 n_tiles + 1,)
  const int* tile_inj;    // row indices
  const float* img_coef;  // (nz, nx) -2 / vp: the imaging variant; or null
  float* fields;          // (2, 3, S, nz, nx): the final fields in buffer 0
  float* work;            // (9, S, nz, nx), zeroed
  float* psi;             // adjoint CPML memories, band storage, zeroed
  float* acc;             // (S, n_acc, nz, nx), zeroed
  float* d_stf;           // (S, nt), zeroed
  int S, nz, nx, nt;
  int rec_row, rec_x0, n_rec, npml, n_acc;
  float dt, src_amp;      // src_amp = src_scale * dt
  StripGeom sg;
  Band bz, bx;
};

__device__ __forceinline__ float* field(const Params& p, int buf, int k,
                                        int s) {
  return p.fields + plane_offset(buf * kAcFields + k, s, p.S, p.nz, p.nx);
}

__device__ __forceinline__ float* work(const Params& p, int k, int s) {
  return p.work + plane_offset(k, s, p.S, p.nz, p.nx);
}

__device__ __forceinline__ float* acc(const Params& p, int k, int s) {
  return p.acc + (static_cast<size_t>(s) * p.n_acc + k) *
                     static_cast<size_t>(p.nz) * p.nx;
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

// The point receivers' cotangent that injection row t adds to its cell of
// shot s at recording index it + 1 (see the note at the top): its entries
// summed in table order.  The caller adds it to the carried cotangent,
// carried + sum, as one rounded add.
__device__ __forceinline__ float injection_sum(const Params& p, int s, int t,
                                               int it) {
  float sum = 0.0f;
  for (int j = p.inj_ptr[t]; j < p.inj_ptr[t + 1]; ++j) {
    sum += p.ent_coef[j] * d_rec(p, s, p.ent_ch[j], p.ent_rec[j], it);
  }
  return sum;
}

// Shared memory of ac_bwd_step_kernel, offsets in floats.  With the 4-cell
// halo: the carried p and D1, D2 of buffer cur.  With the 2-cell halo, the
// velocity phase's inputs: the cotangents of vz and vx, byc_a, byc_b, vz,
// vx (buffer cur); the phase leaves D3, D4 in the first two of these
// planes and the rebuilt vz, vx in the last two; and psi3 (z), psi4 (x) of
// buffer cur.  On the tile, the pressure phase's inputs: the cotangent of
// p, lam, the image coefficient (the imaging variant), psi1 (z), psi2 (x).
// Last, the sum of each thread's first point-receiver row and where it
// lands (an offset into this memory, as int), and the block's runs of rows
// (Runs, as int).  A memory off its band, like any cell off the grid, is
// copied in as 0 and never read.
constexpr int S_IN = 0;                   // 3 planes, 4-cell halo
constexpr int S_V = S_IN + 3 * kH4;       // 6 planes, 2-cell halo
constexpr int S_PV = S_V + 6 * kH2;       // 2 planes, 2-cell halo
constexpr int S_T = S_PV + 2 * kH2;       // 3 planes, tile
constexpr int S_PS = S_T + 3 * kT;        // 2 planes, tile
constexpr int S_INJ = S_PS + 2 * kT;      // a point row's sum a thread
constexpr int S_DST = S_INJ + kTileThreads;  // and where it lands
constexpr int S_RUNS = S_DST + kTileThreads;  // the block's runs
static_assert(S_RUNS + 3 == kAcBwdShared,
              "kAcBwdShared counts this layout");
enum InPlane { I_P = 0, I_D1, I_D2 };
// the velocity phase's planes: inputs, then what it leaves there
enum VelPlane { V_AVZ = 0, V_AVX, V_BYCA, V_BYCB, V_VZ, V_VX };
enum VelOut { V_D3 = 0, V_D4 };
enum TilePlane { T_AP = 0, T_LAM, T_IMG };

// Where injection row t lands in the shared memory of the block whose tile
// starts at (z0, x0): its cell in the copy of the carried cotangent of vz
// or vx (the tile and its 2-cell halo) or of p (the tile).
__device__ __forceinline__ int row_offset(const Params& p, int t, int z0,
                                          int x0) {
  const int c = p.inj_cell[t];
  const int lz = c / p.nx - z0, lx = c % p.nx - x0;
  switch (p.inj_plane[t]) {
    case INJ_VZ: return S_V + V_AVZ * kH2 + (lz + 2) * VX + lx + 2;
    case INJ_VX: return S_V + V_AVX * kH2 + (lz + 2) * VX + lx + 2;
    default: return S_T + T_AP * kT + lz * TX + lx;
  }
}

// This block's runs of the point receivers' rows: its vz/vx rows, then its
// p rows, tile_inj[first .. first + n), the first n_v of them vz/vx.  Kept
// in shared memory (S_RUNS), so that nothing of it stays in a register
// across the velocity phase and no pass waits for device memory to learn
// whether its tile has rows.
struct Runs {
  int first, n_v, n;
};

// Adds rows k0 .. k1-1 of this tile's runs (from `first` in tile_inj) to
// the carried cotangents they land on, carried + sum: the first
// kTileThreads rows as their threads prepared them while the copies were in
// flight, any further row summed now, by the same function.  Each row lands
// on its own value, so no two threads add to one.
__device__ __forceinline__ void add_rows(const Params& p, float* sm,
                                         int first, int k0, int k1, int z0,
                                         int x0, int s, int it) {
  const int* s_dst = reinterpret_cast<const int*>(sm + S_DST);
  for (int k = k0 + threadIdx.x; k < k1; k += kTileThreads) {
    if (k < kTileThreads) {
      sm[s_dst[k]] = sm[s_dst[k]] + sm[S_INJ + k];
    } else {
      const int t = p.tile_inj[first + k];
      float* carried = sm + row_offset(p, t, z0, x0);
      *carried = *carried + injection_sum(p, s, t, it);
    }
  }
}

// Reverse step it for a tile of one shot (see the note at the top); reads
// buffer cur, writes buffer cur ^ 1.  Every value it reads but the
// accumulators comes into shared memory by cp.async at the top, in two
// groups: the first phase waits for its own inputs, and the second phase's
// arrive while it runs.
__global__ void __launch_bounds__(kTileThreads, 4)
ac_bwd_step_kernel(Params p, int it, int cur) {
  __shared__ float sm[kAcBwdShared];
  const int s = blockIdx.z;
  const int z0 = blockIdx.y * TZ, x0 = blockIdx.x * TX;
  const int nz = p.nz, nx = p.nx;
  const int nxt = cur ^ 1;
  const size_t plane_n = static_cast<size_t>(nz) * nx;
  const float* pz = p.prof_z;
  const float* px = p.prof_x;
  const float* any = p.mats;  // a valid address for the copies that read 0
  const bool imaging = p.img_coef != nullptr;

  for (int i = threadIdx.x; i < kH4; i += kTileThreads) {
    const int z = z0 - 4 + i / LX, x = x0 - 4 + i % LX;
    const bool on = z >= 0 && z < nz && x >= 0 && x < nx;
    const size_t c = on ? static_cast<size_t>(z) * nx + x : 0;
    cp_async_f32(&sm[S_IN + I_P * kH4 + i], field(p, cur, F_P, s) + c, on);
    cp_async_f32(&sm[S_IN + I_D1 * kH4 + i], work(p, W_D1 + cur, s) + c, on);
    cp_async_f32(&sm[S_IN + I_D2 * kH4 + i], work(p, W_D2 + cur, s) + c, on);
  }
  for (int i = threadIdx.x; i < kH2; i += kTileThreads) {
    const int z = z0 - 2 + i / VX, x = x0 - 2 + i % VX;
    const bool on = z >= 0 && z < nz && x >= 0 && x < nx;
    const size_t c = on ? static_cast<size_t>(z) * nx + x : 0;
    cp_async_f32(&sm[S_V + V_AVZ * kH2 + i], work(p, W_A_VZ + cur, s) + c,
                 on);
    cp_async_f32(&sm[S_V + V_AVX * kH2 + i], work(p, W_A_VX + cur, s) + c,
                 on);
    cp_async_f32(&sm[S_V + V_BYCA * kH2 + i], p.mats + M_BYC_A * plane_n + c,
                 on);
    cp_async_f32(&sm[S_V + V_BYCB * kH2 + i], p.mats + M_BYC_B * plane_n + c,
                 on);
    cp_async_f32(&sm[S_V + V_VZ * kH2 + i], field(p, cur, F_VZ_AC, s) + c,
                 on);
    cp_async_f32(&sm[S_V + V_VX * kH2 + i], field(p, cur, F_VX_AC, s) + c,
                 on);
    const bool bz = on && in_band(p.bz, z), bx = on && in_band(p.bx, x);
    cp_async_f32(&sm[S_PV + i], bz ? psi_z(p, Z_P3 + cur, s, z, x) : any,
                 bz);
    cp_async_f32(&sm[S_PV + kH2 + i],
                 bx ? psi_x(p, X_P4 + cur, s, z, x) : any, bx);
  }
  // the first phase's inputs are one group, the second phase's another,
  // which arrives while the first phase runs
  cp_async_commit();
  for (int j = threadIdx.x; j < kT; j += kTileThreads) {
    const int z = z0 + j / TX, x = x0 + j % TX;
    const bool on = z < nz && x < nx;
    const size_t c = on ? static_cast<size_t>(z) * nx + x : 0;
    cp_async_f32(&sm[S_T + T_AP * kT + j], work(p, W_A_P, s) + c, on);
    cp_async_f32(&sm[S_T + T_LAM * kT + j], p.mats + M_LAM * plane_n + c,
                 on);
    if (imaging) {
      cp_async_f32(&sm[S_T + T_IMG * kT + j], p.img_coef + c, on);
    }
    const bool bz = on && in_band(p.bz, z), bx = on && in_band(p.bx, x);
    cp_async_f32(&sm[S_PS + j], bz ? psi_z(p, Z_P1, s, z, x) : any, bz);
    cp_async_f32(&sm[S_PS + kT + j], bx ? psi_x(p, X_P2, s, z, x) : any,
                 bx);
  }
  cp_async_commit();
  // each thread's first point row, summed and placed while the copies are
  // in flight
  Runs* s_runs = reinterpret_cast<Runs*>(sm + S_RUNS);
  if (p.inj_ptr != nullptr) {
    const int* ptr = p.tile_ptr + 2 * (blockIdx.y * gridDim.x + blockIdx.x);
    const Runs r{ptr[0], ptr[1] - ptr[0], ptr[2] - ptr[0]};
    if (threadIdx.x == 0) *s_runs = r;
    if (threadIdx.x < r.n) {
      const int t = p.tile_inj[r.first + threadIdx.x];
      reinterpret_cast<int*>(sm + S_DST)[threadIdx.x] = row_offset(p, t, z0,
                                                                   x0);
      sm[S_INJ + threadIdx.x] = injection_sum(p, s, t, it);
    }
  }
  cp_async_wait_group<1>();
  __syncthreads();

  // the vz/vx rows into the carried cotangents on the tile and its 2-cell
  // halo, before the velocity phase reads them; the p rows below
  if (p.inj_ptr != nullptr) {
    const Runs r = *s_runs;
    if (r.n_v > 0) {
      add_rows(p, sm, r.first, 0, r.n_v, z0, x0, s, it);
      __syncthreads();
    }
  }

  const float* s_p = sm + S_IN + I_P * kH4;
  const float* s_d1 = sm + S_IN + I_D1 * kH4;
  const float* s_d2 = sm + S_IN + I_D2 * kH4;
  float* s_v = sm + S_V;

  // velocity phase on the tile and a 2-cell halo
#pragma unroll 1
  for (int i = threadIdx.x; i < kH2; i += kTileThreads) {
    const int lz = i / VX, lx = i % VX;
    const int z = z0 - 2 + lz, x = x0 - 2 + lx;
    if (z < 0 || z >= nz || x < 0 || x >= nx) continue;  // stays 0
    const bool own = lz >= 2 && lz < 2 + TZ && lx >= 2 && lx < 2 + TX;
    const int v = (lz + 2) * LX + lx + 2;
    const size_t c = static_cast<size_t>(z) * nx + x;

    // cotangents of vz, vx after step it: carried, plus the pressure
    // stencils of step it+1 transposed
    float vz_bar = s_v[V_AVZ * kH2 + i] + tile_dz_plus_t<LX>(s_d1, v);
    float vx_bar = s_v[V_AVX * kH2 + i] + tile_dx_minus_t<LX>(s_d2, v);
    // a receiver row's cotangent; point receivers' were added to the
    // carried planes above
    const int r = x - p.rec_x0;
    if (p.inj_ptr == nullptr && z == p.rec_row && r >= 0 && r < p.n_rec) {
      vx_bar += d_rec(p, s, 1, r, it);
      vz_bar += d_rec(p, s, 2, r, it);
    }

    // the velocity stencils of the carried (post-source) p after step it
    const float d3 = tile_dz_minus<LX>(s_p, v);
    const float d4 = tile_dx_plus<LX>(s_p, v);
    const float byca = s_v[V_BYCA * kH2 + i];
    const float bycb = s_v[V_BYCB * kH2 + i];

    // reconstruct vz, vx before step it
    float vz = s_v[V_VZ * kH2 + i];
    float vx = s_v[V_VX * kH2 + i];
    int slot[2];
    if (strip_slots(p.sg, z, x, nz, nx, slot) > 0) {
      const float* in = p.strips + strip_offset(p.sg, s, it, p.nt, kAcFields);
      vz = in[F_VZ_AC * p.sg.n + slot[0]];
      vx = in[F_VX_AC * p.sg.n + slot[0]];
    } else if (in_tight_interior(p, z, x)) {
      vz = __fsub_rn(vz, ac_velocity_increment(
          __fmul_rn(d3, pz[IK * nz + z]), byca, p.dt));
      vx = __fsub_rn(vx, ac_velocity_increment(
          __fmul_rn(d4, px[IK_H * nx + x]), bycb, p.dt));
    }

    // the velocity half-step's adjoint and the buoyancy gradients
    float gz = 0.0f, gx = 0.0f;
    if (in_update_mask(z, x, nz, nx)) {
      gz = vz_bar * byca * p.dt;
      gx = vx_bar * bycb * p.dt;
      if (own && !imaging) {
        const float e3 = d3 * pz[IK * nz + z] + pz[A * nz + z] * d3;
        const float e4 = d4 * px[IK_H * nx + x] + px[A_H * nx + x] * d4;
        acc(p, M_BYC_A, s)[c] += vz_bar * e3 * p.dt;
        acc(p, M_BYC_B, s)[c] += vx_bar * e4 * p.dt;
      }
    }
    float d3_bar, d4_bar;
    if (in_band(p.bz, z)) {
      float m;
      d3_bar = cpml_deriv_adj_to(gz, pz[IK * nz + z], pz[A * nz + z],
                                 pz[B * nz + z], sm[S_PV + i], &m);
      if (own) *psi_z(p, Z_P3 + nxt, s, z, x) = m;
    } else {
      d3_bar = gz * pz[IK * nz + z];
    }
    if (in_band(p.bx, x)) {
      float m;
      d4_bar = cpml_deriv_adj_to(gx, px[IK_H * nx + x], px[A_H * nx + x],
                                 px[B_H * nx + x], sm[S_PV + kH2 + i], &m);
      if (own) *psi_x(p, X_P4 + nxt, s, z, x) = m;
    } else {
      d4_bar = gx * px[IK_H * nx + x];
    }
    // this cell's inputs are read: its planes take what the phase leaves
    s_v[V_D3 * kH2 + i] = d3_bar;
    s_v[V_D4 * kH2 + i] = d4_bar;
    s_v[V_VZ * kH2 + i] = vz;
    s_v[V_VX * kH2 + i] = vx;
    if (own) {
      field(p, nxt, F_VZ_AC, s)[c] = vz;
      field(p, nxt, F_VX_AC, s)[c] = vx;
      work(p, W_A_VZ + nxt, s)[c] = vz_bar;
      work(p, W_A_VX + nxt, s)[c] = vx_bar;
    }
  }
  cp_async_wait_group<0>();  // the second phase's inputs
  __syncthreads();

  // point receivers' p rows of this tile, into the carried cotangent of p
  // on the tile
  if (p.inj_ptr != nullptr) {
    const Runs r = *s_runs;
    if (r.n > r.n_v) {
      add_rows(p, sm, r.first, r.n_v, r.n, z0, x0, s, it);
      __syncthreads();
    }
  }

  // pressure phase on the tile
  const float* s_d3 = s_v + V_D3 * kH2;
  const float* s_d4 = s_v + V_D4 * kH2;
  const float* s_vz = s_v + V_VZ * kH2;
  const float* s_vx = s_v + V_VX * kH2;
  const int src_z = p.src_z[s], src_x = p.src_x[s];
#pragma unroll 1
  for (int j = threadIdx.x; j < kT; j += kTileThreads) {
    const int lz = j / TX, lx = j % TX;
    const int z = z0 + lz, x = x0 + lx;
    if (z >= nz || x >= nx) continue;
    const int t = (lz + 2) * VX + lx + 2;
    const int v = (lz + 4) * LX + lx + 4;
    const size_t c = static_cast<size_t>(z) * nx + x;

    // total cotangent of p after step it: carried (with the point
    // receivers' p), plus the velocity stencils transposed, plus the
    // recorded p on a receiver row
    float p_bar = sm[S_T + T_AP * kT + j] + tile_dz_minus_t<VX>(s_d3, t)
                  + tile_dx_plus_t<VX>(s_d4, t);
    const int r = x - p.rec_x0;
    if (p.inj_ptr == nullptr && z == p.rec_row && r >= 0 && r < p.n_rec) {
      p_bar += d_rec(p, s, 0, r, it);
    }
    const bool src = z == src_z && x == src_x;
    if (src) {
      p.d_stf[static_cast<size_t>(s) * p.nt + it] = p.src_amp * p_bar;
    }

    // the pressure stencils of the velocities before step it
    const float d1 = tile_dz_plus<VX>(s_vz, t);
    const float d2 = tile_dx_minus<VX>(s_vx, t);
    const float lam = sm[S_T + T_LAM * kT + j];

    // reconstruct p before step it
    const float p_after = s_p[v];
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
    field(p, nxt, F_P, s)[c] = p_before;

    // the imaging condition (acoustic.rtm_image_time): the time derivative
    // of the forward pressure against the adjoint pressure, and the source
    // energy
    if (imaging) {
      acc(p, ACC_IMG, s)[c] += sm[S_T + T_IMG * kT + j]
                               * (p_after - p_before) * p_bar;
      acc(p, ACC_ILL, s)[c] += p_before * p_before;
    }

    // the pressure half-step's adjoint and the gradient of lam
    float ge = 0.0f;
    if (in_update_mask(z, x, nz, nx)) {
      const float h = p_bar * p.dt;
      if (!imaging) {
        const float e1 = d1 * pz[IK_H * nz + z] + pz[A_H * nz + z] * d1;
        const float e2 = d2 * px[IK * nx + x] + px[A * nx + x] * d2;
        acc(p, M_LAM, s)[c] += h * (e1 + e2);
      }
      ge = lam * h;
    }
    float d1_bar, d2_bar;
    if (in_band(p.bz, z)) {
      float m = sm[S_PS + j];
      d1_bar = cpml_deriv_adj(ge, pz[IK_H * nz + z], pz[A_H * nz + z],
                              pz[B_H * nz + z], &m);
      *psi_z(p, Z_P1, s, z, x) = m;
    } else {
      d1_bar = ge * pz[IK_H * nz + z];
    }
    if (in_band(p.bx, x)) {
      float m = sm[S_PS + kT + j];
      d2_bar = cpml_deriv_adj(ge, px[IK * nx + x], px[A * nx + x],
                              px[B * nx + x], &m);
      *psi_x(p, X_P2, s, z, x) = m;
    } else {
      d2_bar = ge * px[IK * nx + x];
    }
    work(p, W_D1 + nxt, s)[c] = d1_bar;
    work(p, W_D2 + nxt, s)[c] = d2_bar;
    work(p, W_A_P, s)[c] = p_bar;
  }
}

// acc_sum (n) = the sum over s = 0 .. S-1, in that order, of acc + s * n,
// n = n_acc nz nx: the shared body of shot_sum.cuh with 4 outputs a thread
// (a float4 where n is a multiple of 4 and both planes are 16-byte aligned;
// at the reference workload n = 131,175 or 87,450, so 4 outputs 256 apart)
// and the loads of kGroup shots issued before any add.  Measured on an H100
// (PERF.md, PR 11): at 19 shots of 165 x 265, 4 outputs a thread beat 1 and
// 2, and 20 shots a group beat 8 and 4, cold and inside a backward; 20
// shots a group take 126 registers, too many where one or two shots of a
// large grid leave the resident grid striding over many tiles, so few shots
// take kFewShots.
constexpr int kFewShots = 8, kManyShots = 20;

template <bool kVec, int kGroup>
__global__ void __launch_bounds__(shot_sum::kThreads)
ac_sum_shots_kernel(const float* __restrict__ acc,
                    float* __restrict__ acc_sum, size_t n, int S) {
  shot_sum::sum_shots<kVec, kGroup>(acc, acc_sum, n, S);
}

// Launches ac_sum_shots_kernel over acc (S, n) into acc_sum (n); returns
// the CUDA error (0 on success).
int launch_sum_shots(const float* acc, float* acc_sum, int S, size_t n,
                     cudaStream_t st) {
  static int grid[4] = {0, 0, 0, 0};
  const bool vec = shot_sum::aligned(acc, acc_sum, n);
  if (S <= kFewShots) {
    return vec ? shot_sum::launch(ac_sum_shots_kernel<true, kFewShots>,
                                  &grid[0], n, st, acc, acc_sum, n, S)
               : shot_sum::launch(ac_sum_shots_kernel<false, kFewShots>,
                                  &grid[1], n, st, acc, acc_sum, n, S);
  }
  return vec ? shot_sum::launch(ac_sum_shots_kernel<true, kManyShots>,
                                &grid[2], n, st, acc, acc_sum, n, S)
             : shot_sum::launch(ac_sum_shots_kernel<false, kManyShots>,
                                &grid[3], n, st, acc, acc_sum, n, S);
}

// An empty kernel, launched as the shot sum is (shot_sum::kThreads threads
// a block): what a launch of that grid costs with no work in it.
__global__ void empty_kernel() {}

}  // namespace

// The shot sum alone, as acoustic_backward launches it after its reverse
// steps: acc_sum (n_acc, nz, nx) = the sum over s = 0 .. S-1, in that
// order, of acc (S, n_acc, nz, nx).  For timing it against its bound and
// against one PyTorch call; returns the CUDA error (0 on success).
extern "C" int acoustic_sum_shots(float* acc, float* acc_sum, int S,
                                  int n_acc, int nz, int nx, void* stream) {
  return launch_sum_shots(acc, acc_sum, S,
                          n_acc * static_cast<size_t>(nz) * nx,
                          static_cast<cudaStream_t>(stream));
}

// One launch of empty_kernel over `blocks` blocks on `stream`: the floor
// that chip_smoke.py prints beside the shot sums' times.  Returns the CUDA
// error (0 on success).
extern "C" int empty_launch(int blocks, void* stream) {
  empty_kernel<<<blocks, shot_sum::kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The fused backward's plan, as chip_smoke.py reports it: its static shared
// memory a block in bytes, and the blocks of it an SM of the current device
// holds at once (registers and shared memory together).  Returns the CUDA
// error of the occupancy query.
extern "C" int acoustic_backward_plan(int* out) {
  out[0] = static_cast<int>(kAcBwdShared * sizeof(float));
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], ac_bwd_step_kernel, kTileThreads, 0));
}

// Runs the nt-1 reverse steps for all shots and the shot sum on `stream`
// ((nt-1) + 1 launches, for a receiver row and for point receivers alike:
// inj_ptr null for a row, else the injection table and its rows by tile,
// tile_ptr and tile_inj, built for tile_z x tile_x tiles; tiles other than
// the kernel's return kErrTileMismatch before any launch); returns the
// first CUDA error (0 on success).  Does not synchronise and allocates
// nothing: `fields` (2, 3, S, nz, nx) holds the
// final fields in buffer 0 and returns the fields reconstructed at t=0 in
// buffer (nt-1) % 2; `work` (9, S, nz, nx), `psi` (the adjoint CPML
// memories in band storage, 3 z-memory planes (S, nbz, nx) then 3 x-memory
// planes (S, nz, nbx)), `acc` and `d_stf` arrive zeroed.  With img_coef
// null, `acc` is (S, 3, nz, nx) and `acc_sum` (3, nz, nx) receives the
// gradients of (lam, byc_a, byc_b); with img_coef the (nz, nx) plane
// -2 / vp, `acc` is (S, 2, nz, nx), the image and the illumination of every
// shot, and `acc_sum` (2, nz, nx) their sums over shots.
extern "C" int acoustic_backward(const float* mats, const float* prof_z,
                                 const float* prof_x, const float* stf,
                                 const int* src_z, const int* src_x,
                                 const float* strips, const float* d_data,
                                 const int* inj_ptr, const int* inj_plane,
                                 const int* inj_cell, const int* ent_rec,
                                 const int* ent_ch, const float* ent_coef,
                                 const int* tile_ptr, const int* tile_inj,
                                 const float* img_coef, float* fields,
                                 float* work, float* psi, float* acc,
                                 float* acc_sum, float* d_stf, int S, int nz,
                                 int nx, int nt, int rec_row, int rec_x0,
                                 int n_rec, int tile_z, int tile_x, int npml,
                                 int n_bnd, int band_z_lo, int band_z_hi,
                                 int band_x_lo, int band_x_hi, float dt,
                                 float src_amp, void* stream) {
  if (tile_z != kTileZ || tile_x != kTileX) return kErrTileMismatch;
  const int n_acc = img_coef == nullptr ? 3 : 2;
  Params p{mats, prof_z, prof_x, stf, src_z, src_x, strips, d_data,
           inj_ptr, inj_plane, inj_cell, ent_rec, ent_ch, ent_coef, tile_ptr,
           tile_inj, img_coef, fields, work, psi, acc, d_stf, S, nz,
           nx, nt, rec_row, rec_x0, n_rec, npml, n_acc, dt, src_amp,
           strip_geom(nz, nx, npml, n_bnd), Band{band_z_lo, band_z_hi},
           Band{band_x_lo, band_x_hi}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((nx + TX - 1) / TX, (nz + TZ - 1) / TZ, S);
  for (int k = 0; k < nt - 1; ++k) {
    const int it = nt - 2 - k, cur = k & 1;
    ac_bwd_step_kernel<<<grid, kTileThreads, 0, st>>>(p, it, cur);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch_sum_shots(acc, acc_sum, S,
                          n_acc * static_cast<size_t>(nz) * nx, st);
}
