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
// One fused launch a reverse step (bwd_step_kernel).  A block owns a
// kTileZ x kTileX tile of one shot; a host loop steps it = nt-2 .. 0.
//   load: every value the step reads, into shared memory by cp.async (0
//     off the grid and off a memory's band), so a block waits for device
//     memory about once a step: the stresses after step it and the stress
//     phase's stencil cotangents D1..D4 of step it+1 on the tile and a
//     4-cell halo, what the velocity phase reads at its own cell on the
//     tile and a 2-cell halo, and the buoyancy gradients it accumulates;
//     then, as a second group that arrives while the velocity phase runs,
//     what the stress phase reads at its own cell, its three per-shot
//     gradients among it, on the tile (88,448 bytes of dynamic shared
//     memory, two blocks an SM).  A phase reads a copied value only after
//     the wait for its group and a __syncthreads();
//   velocity phase, on the tile and a 2-cell halo: the cotangents of vz/vx
//     after step it (carried, plus D1..D4 transposed, plus the receivers'
//     cotangent), vz/vx rebuilt before step it (interior increment
//     subtracted, strips injected), the velocity half-step's adjoint:
//     psi5..psi8 recursions and the velocity stencils' cotangents D5..D8,
//     all into shared memory; the owner of a cell writes its vz/vx, their
//     cotangents, its psi5..psi8 and its buoyancy gradients;
//   stress phase, on the tile: the stresses' total cotangents (carried,
//     plus D5..D8 transposed, plus pr at the receivers), d_stf, the stress
//     reconstruction from the rebuilt vz/vx (source subtracted, interior
//     increment subtracted, strips injected), then the stress half-step's
//     adjoint: psi1..psi4, D1..D4 for the next step, the gradients of lam,
//     lp2m and ave_mu.
// D5..D8 never reach device memory.  The halo's velocity phase is
// recomputed by every block that needs it, from the same inputs with the
// same code, and thrown away; only the owner of a cell writes it.  After the
// loop one launch sums the per-shot gradient planes over shots in a fixed
// order (sum_shots_kernel, on the body it shares with acoustic_bwd.cu in
// shot_sum.cuh).  Nothing is accumulated with atomics, so a second
// backward gives the same bits.
//
// Double buffers.  In one launch a block reads at its neighbours' cells the
// fields, the cotangents of vz/vx, D1..D4 and (in the halo's velocity phase)
// psi5..psi8, which their owners write in the same launch; so these live
// twice and reverse step k (it = nt-2-k) reads buffer k % 2 and writes the
// other.  The fields are (2, 5, S, nz, nx), buffer 0 holding the final
// fields on entry; the fields rebuilt at t=0 come back in buffer
// (nt-1) % 2.  The stresses' cotangents, psi1..psi4 and the gradients are
// read and written only by the owner of their cell and live once.
//
// CPML memory only in its bands.  Outside the rows (z-memories) or columns
// (x-memories) where the profile's a is not 0, the adjoint recursion's
// carried cotangent never reaches a result (cpml_deriv_adj returns
// ge ik + a q with a = 0), so the kernel neither reads nor writes it there
// and takes ge ik.  The memories are in band storage (Band,
// elastic_common.cuh) like the forward's.
//
// Point receivers (K1-fiber's transpose).  A receiver at (z, x) sampled vx at
// (z, x), (z, x-1), (z+1, x) and vz at (z, x), (z-1, x), (z, x+1), and
// neighbours on a cable overlap, so one cell can take cotangent from several
// receivers.  A scatter would need atomics and would change the gradient
// from run to run.  Instead the wrapper builds, once per plan, a table in
// compressed-row form: one row per touched (adjoint plane, cell), its
// entries (receiver, channel, coefficient) in a fixed order, and beside it
// the table's rows by the tiles that add them (cuda_engine._injection_tiles,
// built for kTileZ x kTileX tiles; elastic_backward refuses others).  The
// fused step adds a row's sum against the data cotangent of recording index
// it+1 (injection_sum, one __device__ function, the entries in table order)
// to its shared copy of the carried cotangent.  Each thread sums its first
// row of the tile's runs, and finds where in shared memory the row lands,
// while the block's copies are in flight, so that the chain of dependent
// loads (table, entries, data cotangent) overlaps them, and keeps both in
// shared memory; the block adds a vz or vx row after the first cp.async
// group has arrived, in every tile whose velocity phase reads
// the row's cell (the tile and its 2-cell halo, so up to four tiles add the
// same sum, each with the owner's bits), an szz or sxx row after the second
// group has arrived, in the owner's tile alone (the stress phase reads its
// own cells); each pass ends with a __syncthreads() only in a tile with rows
// of its kind, a condition uniform over the block.  A row's cell appears
// once in a tile's run, so no two threads add to one value.  So a backward
// is (nt-1) + 1 launches for points as for a receiver row, whose receivers
// are found by arithmetic inside the launch.
//
// What bounds it on this card: 215 FP32 operations per cell-step
// (reconstruction, both adjoint phases, 8 stencils and 8 transposes, the
// accumulation; chip_smoke.py counts them) and, counting each input once
// and each output once, the strips (2.45 GB at the reference workload) and
// the data cotangent read once: operation-bound at 4.0 ms of FP32 peak.
// What a kernel pays is its traffic: about 43 plane values a cell-step in
// the interior (fields, their cotangents and D1..D4 read and written, 5
// material planes, 5 per-shot gradients read and written; the halo
// reloads mostly from L2).  The halo adds about 40% to the velocity phase's
// operations, which are not what bounds it.  Tensor cores do not apply (FP32 with explicit rounding in
// the reconstruction, which TF32 would break).  TMA is not used for the
// reason given in elastic_fwd.cu (row pitches that are not multiples of 16
// bytes; one tile a block).
//
// Reconstruction uses the increments of elastic_common.cuh, the same code
// and rounding as the forward kernel.

#include "elastic_common.cuh"
#include "shot_sum.cuh"

namespace {

using namespace elastic;

constexpr int TZ = kTileZ, TX = kTileX;
constexpr int LZ = kHalo4Z, LX = kHalo4X;  // loaded, 4-cell halo
constexpr int VZ = kHalo2Z, VX = kHalo2X;  // velocity phase, 2-cell halo

// Plane order of the work buffer (15, S, nz, nx): the stresses' carried
// cotangents once, then the carried cotangents of vz and vx and the stress
// phase's stencil cotangents D1..D4 twice each (buffer b at index + b).
enum Work {
  W_A_SZZ = 0, W_A_SXX, W_A_SXZ,
  W_A_VZ = 3, W_A_VX = 5, W_D1 = 7, W_D2 = 9, W_D3 = 11, W_D4 = 13,
};

// The adjoint CPML memories in band storage: 6 z-memory planes (S, nbz, nx),
// then 6 x-memory planes (S, nz, nbx); the velocity phase's (psi5, psi7;
// psi6, psi8) twice each.
enum AdjPsiZ { Z_P1 = 0, Z_P3 = 1, Z_P5 = 2, Z_P7 = 4 };
enum AdjPsiX { X_P2 = 0, X_P4 = 1, X_P6 = 2, X_P8 = 4 };
constexpr int kPsiPlanes = 6;  // of each axis

// The adjoint planes the injection table names (cuda_engine._A_VZ ..):
// A_VZ, A_VX, A_SZZ, A_SXX.
enum InjPlane { INJ_VZ = 0, INJ_VX, INJ_SZZ, INJ_SXX };

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
  const int* inj_ptr;      // (n_rows + 1,) entry range of each row
  const int* inj_plane;    // (n_rows,) InjPlane
  const int* inj_cell;     // (n_rows,) z * nx + x
  const int* ent_rec;      // (n_ent,) receiver
  const int* ent_ch;       // (n_ent,) channel 0..3
  const float* ent_coef;   // (n_ent,)
  // and its rows by tile: tile t's vz/vx rows (its tile and 2-cell halo) are
  // tile_inj[tile_ptr[2t] : tile_ptr[2t+1]], its szz/sxx rows (its tile)
  // tile_inj[tile_ptr[2t+1] : tile_ptr[2t+2]], each run in table order
  const int* tile_ptr;     // (2 n_tiles + 1,)
  const int* tile_inj;     // row indices
  float* fields;        // (2, 5, S, nz, nx): the final fields in buffer 0
  float* work;          // (15, S, nz, nx), zeroed
  float* psi;           // adjoint CPML memories, band storage, zeroed
  float* gshot;         // (S, 5, nz, nx), zeroed
  float* gmat;          // (5, nz, nx)
  float* d_stf;         // (S, nt), zeroed
  int S, nz, nx, nt;
  int rec_row, rec_x0, n_rec, ett_ezz, npml;
  float dt, src_amp;    // src_amp = src_scale * dt
  StripGeom sg;
  Band bz, bx;
};

__device__ __forceinline__ float* field(const Params& p, int buf, int k,
                                        int s) {
  return p.fields + plane_offset(buf * kNumFields + k, s, p.S, p.nz, p.nx);
}

__device__ __forceinline__ float* work(const Params& p, int k, int s) {
  return p.work + plane_offset(k, s, p.S, p.nz, p.nx);
}

__device__ __forceinline__ float* grad(const Params& p, int k, int s) {
  return p.gshot + (static_cast<size_t>(s) * kNumFields + k) *
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

// The point receivers' cotangent that injection row t adds to its cell of
// shot s at recording index it + 1 (see the note at the top): its entries
// summed in table order.  The caller adds it to the carried cotangent,
// carried + sum, as one rounded add.
__device__ __forceinline__ float injection_sum(const Params& p, int s, int t,
                                               int it) {
  float acc = 0.0f;
  for (int j = p.inj_ptr[t]; j < p.inj_ptr[t + 1]; ++j) {
    acc += p.ent_coef[j] * d_rec(p, s, p.ent_ch[j], p.ent_rec[j], it);
  }
  return acc;
}

// Shared memory of bwd_step_kernel (dynamic), offsets in floats.  With the
// 4-cell halo: szz, sxx, sxz and D1..D4 of buffer cur.  With the 2-cell
// halo, the velocity phase's inputs: the cotangents of vz and vx, vz, vx
// (buffer cur), byc_a, byc_b; the phase leaves D5, D6, D7, D8 in the first
// four of these planes and the rebuilt vz, vx in the last two; and psi5,
// psi7 (z), psi6, psi8 (x) of buffer cur.  On the tile, the stress phase's
// inputs: the stresses' cotangents, lam, lp2m, ave_mu, psi1, psi3 (z),
// psi2, psi4 (x), and the 5 per-shot gradients.  Last, the sum of each
// thread's first point-receiver row and where it lands (an offset into
// this memory, as int).  A memory off its band, like any cell off the
// grid, is copied in as 0 and never read.
constexpr int S_IN = 0;                   // 7 planes, 4-cell halo
constexpr int S_V = S_IN + 7 * kH4;       // 6 planes, 2-cell halo
constexpr int S_PV = S_V + 6 * kH2;       // 4 planes, 2-cell halo
constexpr int S_T = S_PV + 4 * kH2;       // 6 planes, tile
constexpr int S_PS = S_T + 6 * kT;        // 4 planes, tile
constexpr int S_G = S_PS + 4 * kT;        // 5 planes, tile
constexpr int S_INJ = S_G + 5 * kT;       // a point row's sum a thread
constexpr int S_DST = S_INJ + kTileThreads;  // and where it lands
static_assert(S_DST + kTileThreads == kBwdShared,
              "kBwdShared counts this layout");
enum InPlane { I_SZZ = 0, I_SXX, I_SXZ, I_D1, I_D2, I_D3, I_D4 };
// the velocity phase's planes: inputs, then what it leaves there
enum VelPlane { V_AVZ = 0, V_AVX, V_BYCA, V_BYCB, V_VZ, V_VX };
enum VelOut { V_D5 = 0, V_D6, V_D7, V_D8 };

// Where injection row t lands in the shared memory of the block whose tile
// starts at (z0, x0): its cell in the copy of the carried cotangent of vz
// or vx (the tile and its 2-cell halo) or of szz or sxx (the tile).
__device__ __forceinline__ int row_offset(const Params& p, int t, int z0,
                                          int x0) {
  const int c = p.inj_cell[t];
  const int lz = c / p.nx - z0, lx = c % p.nx - x0;
  switch (p.inj_plane[t]) {
    case INJ_VZ: return S_V + V_AVZ * kH2 + (lz + 2) * kHalo2X + lx + 2;
    case INJ_VX: return S_V + V_AVX * kH2 + (lz + 2) * kHalo2X + lx + 2;
    case INJ_SZZ: return S_T + lz * kTileX + lx;
    default: return S_T + kT + lz * kTileX + lx;
  }
}

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
// buffer cur, writes buffer cur ^ 1.  Every value it reads comes into
// shared memory by cp.async at the top, in two groups: the first phase
// waits for its own inputs, and the second phase's arrive while it runs.
__global__ void __launch_bounds__(kTileThreads, 2)
bwd_step_kernel(Params p, int it, int cur) {
  extern __shared__ float sm[];
  const int s = blockIdx.z;
  const int z0 = blockIdx.y * TZ, x0 = blockIdx.x * TX;
  const int nz = p.nz, nx = p.nx;
  const int nxt = cur ^ 1;
  const size_t plane_n = static_cast<size_t>(nz) * nx;
  const float* pz = p.prof_z;
  const float* px = p.prof_x;
  const float* any = p.mats;  // a valid address for the copies that read 0

  // point receivers' rows of this tile: its vz/vx rows, then its szz/sxx
  // rows, inj_first .. + n_inj in tile_inj
  int inj_first = 0, n_inj_v = 0, n_inj = 0;
  if (p.inj_ptr != nullptr) {
    const int t = 2 * (blockIdx.y * gridDim.x + blockIdx.x);
    inj_first = p.tile_ptr[t];
    n_inj_v = p.tile_ptr[t + 1] - inj_first;
    n_inj = p.tile_ptr[t + 2] - inj_first;
  }

  for (int i = threadIdx.x; i < kH4; i += kTileThreads) {
    const int z = z0 - 4 + i / LX, x = x0 - 4 + i % LX;
    const bool on = z >= 0 && z < nz && x >= 0 && x < nx;
    const size_t c = on ? static_cast<size_t>(z) * nx + x : 0;
    cp_async_f32(&sm[S_IN + I_SZZ * kH4 + i], field(p, cur, F_SZZ, s) + c,
                 on);
    cp_async_f32(&sm[S_IN + I_SXX * kH4 + i], field(p, cur, F_SXX, s) + c,
                 on);
    cp_async_f32(&sm[S_IN + I_SXZ * kH4 + i], field(p, cur, F_SXZ, s) + c,
                 on);
    cp_async_f32(&sm[S_IN + I_D1 * kH4 + i], work(p, W_D1 + cur, s) + c, on);
    cp_async_f32(&sm[S_IN + I_D2 * kH4 + i], work(p, W_D2 + cur, s) + c, on);
    cp_async_f32(&sm[S_IN + I_D3 * kH4 + i], work(p, W_D3 + cur, s) + c, on);
    cp_async_f32(&sm[S_IN + I_D4 * kH4 + i], work(p, W_D4 + cur, s) + c, on);
  }
  for (int i = threadIdx.x; i < kH2; i += kTileThreads) {
    const int z = z0 - 2 + i / VX, x = x0 - 2 + i % VX;
    const bool on = z >= 0 && z < nz && x >= 0 && x < nx;
    const size_t c = on ? static_cast<size_t>(z) * nx + x : 0;
    cp_async_f32(&sm[S_V + V_AVZ * kH2 + i], work(p, W_A_VZ + cur, s) + c,
                 on);
    cp_async_f32(&sm[S_V + V_AVX * kH2 + i], work(p, W_A_VX + cur, s) + c,
                 on);
    cp_async_f32(&sm[S_V + V_BYCA * kH2 + i], p.mats + BYC_A * plane_n + c,
                 on);
    cp_async_f32(&sm[S_V + V_BYCB * kH2 + i], p.mats + BYC_B * plane_n + c,
                 on);
    cp_async_f32(&sm[S_V + V_VZ * kH2 + i], field(p, cur, F_VZ, s) + c, on);
    cp_async_f32(&sm[S_V + V_VX * kH2 + i], field(p, cur, F_VX, s) + c, on);
    const bool bz = on && in_band(p.bz, z), bx = on && in_band(p.bx, x);
    cp_async_f32(&sm[S_PV + i], bz ? psi_z(p, Z_P5 + cur, s, z, x) : any,
                 bz);
    cp_async_f32(&sm[S_PV + kH2 + i],
                 bz ? psi_z(p, Z_P7 + cur, s, z, x) : any, bz);
    cp_async_f32(&sm[S_PV + 2 * kH2 + i],
                 bx ? psi_x(p, X_P6 + cur, s, z, x) : any, bx);
    cp_async_f32(&sm[S_PV + 3 * kH2 + i],
                 bx ? psi_x(p, X_P8 + cur, s, z, x) : any, bx);
  }
  // the buoyancy gradients, which the first phase accumulates
  for (int j = threadIdx.x; j < kT; j += kTileThreads) {
    const int z = z0 + j / TX, x = x0 + j % TX;
    const bool on = z < nz && x < nx;
    const size_t c = on ? static_cast<size_t>(z) * nx + x : 0;
    cp_async_f32(&sm[S_G + BYC_A * kT + j], grad(p, BYC_A, s) + c, on);
    cp_async_f32(&sm[S_G + BYC_B * kT + j], grad(p, BYC_B, s) + c, on);
  }
  // the first phase's inputs are one group, the second phase's another,
  // which arrives while the first phase runs
  cp_async_commit();
  for (int j = threadIdx.x; j < kT; j += kTileThreads) {
    const int z = z0 + j / TX, x = x0 + j % TX;
    const bool on = z < nz && x < nx;
    const size_t c = on ? static_cast<size_t>(z) * nx + x : 0;
    cp_async_f32(&sm[S_T + j], work(p, W_A_SZZ, s) + c, on);
    cp_async_f32(&sm[S_T + kT + j], work(p, W_A_SXX, s) + c, on);
    cp_async_f32(&sm[S_T + 2 * kT + j], work(p, W_A_SXZ, s) + c, on);
    cp_async_f32(&sm[S_T + 3 * kT + j], p.mats + LAM * plane_n + c, on);
    cp_async_f32(&sm[S_T + 4 * kT + j], p.mats + LP2M * plane_n + c, on);
    cp_async_f32(&sm[S_T + 5 * kT + j], p.mats + AVE_MU * plane_n + c, on);
    const bool bz = on && in_band(p.bz, z), bx = on && in_band(p.bx, x);
    cp_async_f32(&sm[S_PS + j], bz ? psi_z(p, Z_P1, s, z, x) : any, bz);
    cp_async_f32(&sm[S_PS + kT + j], bz ? psi_z(p, Z_P3, s, z, x) : any, bz);
    cp_async_f32(&sm[S_PS + 2 * kT + j], bx ? psi_x(p, X_P2, s, z, x) : any,
                 bx);
    cp_async_f32(&sm[S_PS + 3 * kT + j], bx ? psi_x(p, X_P4, s, z, x) : any,
                 bx);
#pragma unroll
    for (int k = LAM; k <= AVE_MU; ++k) {
      cp_async_f32(&sm[S_G + k * kT + j], grad(p, k, s) + c, on);
    }
  }
  cp_async_commit();
  // each thread's first row, summed and placed while the copies are in
  // flight
  if (threadIdx.x < n_inj) {
    const int t = p.tile_inj[inj_first + threadIdx.x];
    reinterpret_cast<int*>(sm + S_DST)[threadIdx.x] = row_offset(p, t, z0,
                                                                 x0);
    sm[S_INJ + threadIdx.x] = injection_sum(p, s, t, it);
  }
  cp_async_wait_group<1>();
  __syncthreads();

  const float* s_szz = sm + S_IN + I_SZZ * kH4;
  const float* s_sxx = sm + S_IN + I_SXX * kH4;
  const float* s_sxz = sm + S_IN + I_SXZ * kH4;
  float* s_v = sm + S_V;

  // the vz/vx rows into the carried cotangents on the tile and its 2-cell
  // halo, before the velocity phase reads them; the szz/sxx rows below
  if (n_inj_v > 0) {
    add_rows(p, sm, inj_first, 0, n_inj_v, z0, x0, s, it);
    __syncthreads();
  }

  // velocity phase on the tile and a 2-cell halo
#pragma unroll 1
  for (int i = threadIdx.x; i < kH2; i += kTileThreads) {
    const int lz = i / VX, lx = i % VX;
    const int z = z0 - 2 + lz, x = x0 - 2 + lx;
    if (z < 0 || z >= nz || x < 0 || x >= nx) continue;  // stays 0
    const bool own = lz >= 2 && lz < 2 + TZ && lx >= 2 && lx < 2 + TX;
    const int v = (lz + 2) * LX + lx + 2;
    const size_t c = static_cast<size_t>(z) * nx + x;

    // cotangents of vz, vx after step it: carried, plus the stress
    // stencils of step it+1 transposed
    float vz_bar = s_v[V_AVZ * kH2 + i]
                   + tile_dz_minus_t<LX>(sm + S_IN + I_D1 * kH4, v)
                   + tile_dx_plus_t<LX>(sm + S_IN + I_D4 * kH4, v);
    float vx_bar = s_v[V_AVX * kH2 + i]
                   + tile_dx_minus_t<LX>(sm + S_IN + I_D2 * kH4, v)
                   + tile_dz_plus_t<LX>(sm + S_IN + I_D3 * kH4, v);

    // a receiver row's cotangent (propagator._record transposed); point
    // receivers' were added to the carried planes above
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
    const float d5 = tile_dz_plus<LX>(s_szz, v);
    const float d6 = tile_dx_minus<LX>(s_sxz, v);
    const float d7 = tile_dz_minus<LX>(s_sxz, v);
    const float d8 = tile_dx_plus<LX>(s_sxx, v);
    const float byca = s_v[V_BYCA * kH2 + i];
    const float bycb = s_v[V_BYCB * kH2 + i];

    // reconstruct vz, vx before step it
    float vz = s_v[V_VZ * kH2 + i];
    float vx = s_v[V_VX * kH2 + i];
    int slot[2];
    if (strip_slots(p.sg, z, x, nz, nx, slot) > 0) {
      const float* in = p.strips + strip_offset(p.sg, s, it, p.nt);
      vz = in[F_VZ * p.sg.n + slot[0]];
      vx = in[F_VX * p.sg.n + slot[0]];
    } else if (in_interior(p, z, x)) {
      vz = __fsub_rn(vz, velocity_increment(
          __fmul_rn(d5, pz[IK_H * nz + z]), __fmul_rn(d6, px[IK * nx + x]),
          byca, p.dt));
      vx = __fsub_rn(vx, velocity_increment(
          __fmul_rn(d7, pz[IK * nz + z]), __fmul_rn(d8, px[IK_H * nx + x]),
          bycb, p.dt));
    }

    // the velocity half-step's adjoint and the buoyancy gradients
    float gz = 0.0f, gx = 0.0f;
    if (in_update_mask(z, x, nz, nx)) {
      gz = vz_bar * byca * p.dt;
      gx = vx_bar * bycb * p.dt;
      if (own) {
        const int j = (lz - 2) * TX + lx - 2;
        const float e5 = d5 * pz[IK_H * nz + z] + pz[A_H * nz + z] * d5;
        const float e6 = d6 * px[IK * nx + x] + px[A * nx + x] * d6;
        const float e7 = d7 * pz[IK * nz + z] + pz[A * nz + z] * d7;
        const float e8 = d8 * px[IK_H * nx + x] + px[A_H * nx + x] * d8;
        grad(p, BYC_A, s)[c] = sm[S_G + BYC_A * kT + j]
                               + vz_bar * (e5 + e6) * p.dt;
        grad(p, BYC_B, s)[c] = sm[S_G + BYC_B * kT + j]
                               + vx_bar * (e7 + e8) * p.dt;
      }
    }
    float d5_bar, d6_bar, d7_bar, d8_bar;
    if (in_band(p.bz, z)) {
      float m5, m7;
      d5_bar = cpml_deriv_adj_to(gz, pz[IK_H * nz + z], pz[A_H * nz + z],
                                 pz[B_H * nz + z], sm[S_PV + i], &m5);
      d7_bar = cpml_deriv_adj_to(gx, pz[IK * nz + z], pz[A * nz + z],
                                 pz[B * nz + z], sm[S_PV + kH2 + i], &m7);
      if (own) {
        *psi_z(p, Z_P5 + nxt, s, z, x) = m5;
        *psi_z(p, Z_P7 + nxt, s, z, x) = m7;
      }
    } else {
      d5_bar = gz * pz[IK_H * nz + z];
      d7_bar = gx * pz[IK * nz + z];
    }
    if (in_band(p.bx, x)) {
      float m6, m8;
      d6_bar = cpml_deriv_adj_to(gz, px[IK * nx + x], px[A * nx + x],
                                 px[B * nx + x], sm[S_PV + 2 * kH2 + i], &m6);
      d8_bar = cpml_deriv_adj_to(gx, px[IK_H * nx + x], px[A_H * nx + x],
                                 px[B_H * nx + x], sm[S_PV + 3 * kH2 + i],
                                 &m8);
      if (own) {
        *psi_x(p, X_P6 + nxt, s, z, x) = m6;
        *psi_x(p, X_P8 + nxt, s, z, x) = m8;
      }
    } else {
      d6_bar = gz * px[IK * nx + x];
      d8_bar = gx * px[IK_H * nx + x];
    }
    // this cell's inputs are read: its planes take what the phase leaves
    s_v[V_D5 * kH2 + i] = d5_bar;
    s_v[V_D6 * kH2 + i] = d6_bar;
    s_v[V_D7 * kH2 + i] = d7_bar;
    s_v[V_D8 * kH2 + i] = d8_bar;
    s_v[V_VZ * kH2 + i] = vz;
    s_v[V_VX * kH2 + i] = vx;
    if (own) {
      field(p, nxt, F_VZ, s)[c] = vz;
      field(p, nxt, F_VX, s)[c] = vx;
      work(p, W_A_VZ + nxt, s)[c] = vz_bar;
      work(p, W_A_VX + nxt, s)[c] = vx_bar;
    }
  }
  cp_async_wait_group<0>();  // the second phase's inputs
  __syncthreads();

  // point receivers' szz/sxx rows of this tile, into the stresses' carried
  // cotangents on the tile
  if (n_inj > n_inj_v) {
    add_rows(p, sm, inj_first, n_inj_v, n_inj, z0, x0, s, it);
    __syncthreads();
  }

  // stress phase on the tile
  const float* s_d5 = s_v + V_D5 * kH2;
  const float* s_d6 = s_v + V_D6 * kH2;
  const float* s_d7 = s_v + V_D7 * kH2;
  const float* s_d8 = s_v + V_D8 * kH2;
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

    // total cotangents of the stresses after step it: carried (with the
    // point receivers' pr), plus the velocity stencils transposed, plus pr
    // on a receiver row
    float szz_bar = sm[S_T + j] + tile_dz_plus_t<VX>(s_d5, t);
    float sxx_bar = sm[S_T + kT + j] + tile_dx_plus_t<VX>(s_d8, t);
    const float sxz_bar = sm[S_T + 2 * kT + j]
                          + tile_dx_minus_t<VX>(s_d6, t)
                          + tile_dz_minus_t<VX>(s_d7, t);
    const int r = x - p.rec_x0;
    if (p.inj_ptr == nullptr && z == p.rec_row && r >= 0 && r < p.n_rec) {
      const float pr = d_rec(p, s, 0, r, it);
      szz_bar += pr;
      sxx_bar += pr;
    }
    const bool src = z == src_z && x == src_x;
    if (src) {
      p.d_stf[static_cast<size_t>(s) * p.nt + it] =
          p.src_amp * (szz_bar + p.rxz[s] * sxx_bar);
    }

    // the stress stencils of the velocities before step it
    const float d1 = tile_dz_minus<VX>(s_vz, t);
    const float d2 = tile_dx_minus<VX>(s_vx, t);
    const float d3 = tile_dz_plus<VX>(s_vx, t);
    const float d4 = tile_dx_plus<VX>(s_vz, t);
    const float lam = sm[S_T + 3 * kT + j];
    const float lp2m = sm[S_T + 4 * kT + j];
    const float mu = sm[S_T + 5 * kT + j];

    // reconstruct the stresses before step it
    float szz, sxx, sxz;
    int slot[2];
    if (strip_slots(p.sg, z, x, nz, nx, slot) > 0) {
      const float* in = p.strips + strip_offset(p.sg, s, it, p.nt);
      szz = in[F_SZZ * p.sg.n + slot[0]];
      sxx = in[F_SXX * p.sg.n + slot[0]];
      sxz = in[F_SXZ * p.sg.n + slot[0]];
    } else {
      szz = s_szz[v];
      sxx = s_sxx[v];
      sxz = s_sxz[v];
      if (src) {
        const float amp = source_amp(p.stf, s, it, p.nt, p.src_amp);
        szz = __fsub_rn(szz, amp);
        sxx = __fsub_rn(sxx, __fmul_rn(p.rxz[s], amp));
      }
      if (in_interior(p, z, x)) {
        const StressInc inc = stress_increment(
            __fmul_rn(d1, pz[IK * nz + z]), __fmul_rn(d2, px[IK * nx + x]),
            __fmul_rn(d3, pz[IK_H * nz + z]), __fmul_rn(d4, px[IK_H * nx + x]),
            lam, lp2m, mu, p.dt);
        szz = __fsub_rn(szz, inc.zz);
        sxx = __fsub_rn(sxx, inc.xx);
        sxz = __fsub_rn(sxz, inc.xz);
      }
    }
    field(p, nxt, F_SZZ, s)[c] = szz;
    field(p, nxt, F_SXX, s)[c] = sxx;
    field(p, nxt, F_SXZ, s)[c] = sxz;

    // the stress half-step's adjoint and the gradients of lam, lp2m, ave_mu
    float ge_zz = 0.0f, ge_xx = 0.0f, ge_s = 0.0f;
    if (in_update_mask(z, x, nz, nx)) {
      const float hzz = szz_bar * p.dt;
      const float hxx = sxx_bar * p.dt;
      const float hxz = sxz_bar * p.dt;
      const float e1 = d1 * pz[IK * nz + z] + pz[A * nz + z] * d1;
      const float e2 = d2 * px[IK * nx + x] + px[A * nx + x] * d2;
      const float e3 = d3 * pz[IK_H * nz + z] + pz[A_H * nz + z] * d3;
      const float e4 = d4 * px[IK_H * nx + x] + px[A_H * nx + x] * d4;
      grad(p, LAM, s)[c] = sm[S_G + LAM * kT + j] + (hzz * e2 + hxx * e1);
      grad(p, LP2M, s)[c] = sm[S_G + LP2M * kT + j] + (hzz * e1 + hxx * e2);
      grad(p, AVE_MU, s)[c] = sm[S_G + AVE_MU * kT + j] + hxz * (e3 + e4);
      ge_zz = lp2m * hzz + lam * hxx;
      ge_xx = lam * hzz + lp2m * hxx;
      ge_s = mu * hxz;
    }
    float d1_bar, d2_bar, d3_bar, d4_bar;
    if (in_band(p.bz, z)) {
      float m1 = sm[S_PS + j], m3 = sm[S_PS + kT + j];
      d1_bar = cpml_deriv_adj(ge_zz, pz[IK * nz + z], pz[A * nz + z],
                              pz[B * nz + z], &m1);
      d3_bar = cpml_deriv_adj(ge_s, pz[IK_H * nz + z], pz[A_H * nz + z],
                              pz[B_H * nz + z], &m3);
      *psi_z(p, Z_P1, s, z, x) = m1;
      *psi_z(p, Z_P3, s, z, x) = m3;
    } else {
      d1_bar = ge_zz * pz[IK * nz + z];
      d3_bar = ge_s * pz[IK_H * nz + z];
    }
    if (in_band(p.bx, x)) {
      float m2 = sm[S_PS + 2 * kT + j], m4 = sm[S_PS + 3 * kT + j];
      d2_bar = cpml_deriv_adj(ge_xx, px[IK * nx + x], px[A * nx + x],
                              px[B * nx + x], &m2);
      d4_bar = cpml_deriv_adj(ge_s, px[IK_H * nx + x], px[A_H * nx + x],
                              px[B_H * nx + x], &m4);
      *psi_x(p, X_P2, s, z, x) = m2;
      *psi_x(p, X_P4, s, z, x) = m4;
    } else {
      d2_bar = ge_xx * px[IK * nx + x];
      d4_bar = ge_s * px[IK_H * nx + x];
    }
    work(p, W_D1 + nxt, s)[c] = d1_bar;
    work(p, W_D2 + nxt, s)[c] = d2_bar;
    work(p, W_D3 + nxt, s)[c] = d3_bar;
    work(p, W_D4 + nxt, s)[c] = d4_bar;
    work(p, W_A_SZZ, s)[c] = szz_bar;
    work(p, W_A_SXX, s)[c] = sxx_bar;
    work(p, W_A_SXZ, s)[c] = sxz_bar;
  }
}

// gmat[c] = sum over s = 0 .. S-1, in that order, of gshot[s * n + c],
// with n = 5 nz nx: the shared body of shot_sum.cuh with 4 outputs a thread
// and the loads of 4 shots issued before any add.  The float4 variant
// (<true>) needs n a multiple of 4 and both planes 16-byte aligned (not so
// at the reference workload, n = 218,625).
template <bool kVec>
__global__ void __launch_bounds__(shot_sum::kThreads)
sum_shots_kernel(const float* __restrict__ gshot, float* __restrict__ gmat,
                 size_t n, int S) {
  shot_sum::sum_shots<kVec, 4>(gshot, gmat, n, S);
}

// Launches sum_shots_kernel over gshot (S, 5, nz, nx) into gmat (5, nz,
// nx), the float4 variant where the per-shot stride and both planes allow
// it; returns the CUDA error (0 on success).
int launch_sum_shots(const float* gshot, float* gmat, int S, int nz, int nx,
                     cudaStream_t st) {
  const size_t n = kNumFields * static_cast<size_t>(nz) * nx;
  static int grid[2] = {0, 0};
  if (shot_sum::aligned(gshot, gmat, n)) {
    return shot_sum::launch(sum_shots_kernel<true>, &grid[1], n, st, gshot,
                            gmat, n, S);
  }
  return shot_sum::launch(sum_shots_kernel<false>, &grid[0], n, st, gshot,
                          gmat, n, S);
}

}  // namespace

// The blocks of bwd_step_kernel, with its dynamic shared memory, that one SM
// of this device holds at once, into out[0]; returns the CUDA error (0 on
// success).
extern "C" int elastic_backward_plan(int* out) {
  const int smem = static_cast<int>(kBwdShared * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      bwd_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], bwd_step_kernel, kTileThreads, smem));
}

// The shot sum alone, as elastic_backward launches it after its reverse
// steps: gmat (5, nz, nx) = the sum over s = 0 .. S-1, in that order, of
// gshot (S, 5, nz, nx).  For timing it against its bound and against one
// PyTorch call; returns the CUDA error (0 on success).
extern "C" int elastic_sum_shots(float* gshot, float* gmat, int S, int nz,
                                 int nx, void* stream) {
  return launch_sum_shots(gshot, gmat, S, nz, nx,
                          static_cast<cudaStream_t>(stream));
}

// Runs the nt-1 reverse steps for all shots and the shot sum on `stream`
// ((nt-1) + 1 launches, for a receiver row and for point receivers alike:
// inj_ptr null for a row, else the injection table and its rows by tile,
// tile_ptr and tile_inj, built for tile_z x tile_x tiles; tiles other than
// the kernel's return kErrTileMismatch before any launch); returns the first
// CUDA error (0 on success).
// Does not synchronise and allocates nothing: `fields` (2, 5, S, nz, nx)
// holds the final fields in buffer 0 and returns the fields reconstructed
// at t=0 in buffer (nt-1) % 2; `work` (15, S, nz, nx), `psi` (the adjoint
// CPML memories in band storage, 6 z-memory planes (S, nbz, nx) then 6
// x-memory planes (S, nz, nbx)), `gshot` and `d_stf` arrive zeroed; `gmat`
// receives the gradients.
extern "C" int elastic_backward(const float* mats, const float* prof_z,
                                const float* prof_x, const float* stf,
                                const int* src_z, const int* src_x,
                                const float* rxz, const float* strips,
                                const float* d_data, const int* inj_ptr,
                                const int* inj_plane, const int* inj_cell,
                                const int* ent_rec, const int* ent_ch,
                                const float* ent_coef, const int* tile_ptr,
                                const int* tile_inj, float* fields,
                                float* work, float* psi, float* gshot,
                                float* gmat, float* d_stf, int S, int nz,
                                int nx, int nt, int rec_row, int rec_x0,
                                int n_rec, int ett_mode, int tile_z,
                                int tile_x, int npml, int n_bnd,
                                int band_z_lo, int band_z_hi, int band_x_lo,
                                int band_x_hi, float dt, float src_amp,
                                void* stream) {
  if (tile_z != kTileZ || tile_x != kTileX) return kErrTileMismatch;
  Params p{mats, prof_z, prof_x, stf, src_z, src_x, rxz, strips, d_data,
           inj_ptr, inj_plane, inj_cell, ent_rec, ent_ch, ent_coef,
           tile_ptr, tile_inj, fields, work, psi, gshot, gmat, d_stf, S, nz,
           nx, nt, rec_row, rec_x0, n_rec, ett_mode == elastic::ETT_EZZ,
           npml, dt, src_amp, strip_geom(nz, nx, npml, n_bnd),
           Band{band_z_lo, band_z_hi}, Band{band_x_lo, band_x_hi}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(kBwdShared * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      bwd_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nx + TX - 1) / TX, (nz + TZ - 1) / TZ, S);
  for (int k = 0; k < nt - 1; ++k) {
    const int it = nt - 2 - k, cur = k & 1;
    bwd_step_kernel<<<grid, kTileThreads, smem, st>>>(p, it, cur);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch_sum_shots(gshot, gmat, S, nz, nx, st);
}
