// Elastic forward modeling on Hopper: nt-1 leapfrog steps of the O(4)
// staggered velocity-stress scheme with division-free CPML, an explosive
// point source and row recording of (pr, vx, vz, ett), for all shots.
//
// Replaces sep2023_tpu/ops/pallas_engine.py::_run_forward with
// save_strips=False (the K1 Pallas kernel, pallas_call at line 875, body
// _fwd_body/_step_values/_record_rows).  It computes what K1 computes; it
// does not copy K1's TPU layout (no 128-lane padding, no cyclic rolls, no
// VMEM ring, no DMA chunking).  A stencil neighbour outside the grid reads
// as 0, the zero-padded edge of ops/fd.py (_padz/_padx); inside the update
// mask [2, n-3] both edge rules give the same values.
//
// What bounds it on this card: each cell-step reads and writes about 36 f32
// values across the two phases (5 fields, 8 psi, 5 material planes, stencil
// neighbours mostly from L1/L2), about 144 B.  The kernel is memory bound.
// At the reference workload (165x265 padded grid, 19 shots) the state of all
// shots, 13 planes x 165 x 265 x 4 B x 19 = 43 MB, is close to the 50 MB L2,
// so much of that traffic stays in L2.  This first version is one thread per
// cell, three launches per step; shared-memory tiles with halos, temporal
// blocking, a persistent kernel and CUDA graphs are later work.
//
// Recording is its own launch: the ett sample vx[r,x] - vx[r,x-1] is taken
// on the post-update field, and a neighbour's new vx is not visible inside
// the launch that writes it.
//
// Rounding: nvcc contracts a*b+c into FMAs by default, so results differ
// from the XLA/Pallas ones in the last bits (the tests hold 2e-5 per
// channel, relative to the channel max).  The boundary-saving gradient needs
// the forward and the time-reversed interior updates of this engine to match
// bitwise; whether that needs --fmad=false is decided with that kernel.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kC1 = static_cast<float>(9.0 / 8.0);
constexpr float kC2 = static_cast<float>(1.0 / 24.0);

constexpr int kBlockX = 32;
constexpr int kBlockZ = 8;
constexpr int kRecThreads = 128;

// Plane order of the state buffer (13, S, nz, nx).
enum Plane {
  VZ = 0, VX, SZZ, SXX, SXZ,
  P_VZ_DZ, P_VX_DX, P_VX_DZ, P_VZ_DX,
  P_SZZ_DZ, P_SXZ_DX, P_SXZ_DZ, P_SXX_DX,
};

// Material planes (5, nz, nx): lam, lam + 2 mu, harmonic mu, two buoyancies.
enum Mat { LAM = 0, LP2M, AVE_MU, BYC_A, BYC_B };

// Profile rows: prof_z (6, nz) and prof_x (6, nx), as cpml.CpmlScaled.
enum Prof { IK = 0, A, B, IK_H, A_H, B_H };

struct Params {
  const float* mats;    // (5, nz, nx)
  const float* prof_z;  // (6, nz)
  const float* prof_x;  // (6, nx)
  const float* stf;     // (S, nt)
  const int* src_z;     // (S,)
  const int* src_x;     // (S,)
  const float* rxz;     // (S,)
  float* state;         // (13, S, nz, nx)
  float* data;          // (S, 4, R, nt)
  int S, nz, nx, nt;
  int rec_row, rec_x0, n_rec, ett_ezz;
  float dt, src_amp;    // src_amp = src_scale * dt
};

__device__ __forceinline__ float* plane(const Params& p, int k, int s) {
  return p.state + (static_cast<size_t>(k) * p.S + s) *
                       static_cast<size_t>(p.nz) * p.nx;
}

// Zero outside the grid: the zero-padded edge of ops/fd.py.
__device__ __forceinline__ float at(const float* f, int z, int x, int nz,
                                    int nx) {
  return (z >= 0 && z < nz && x >= 0 && x < nx)
             ? f[static_cast<size_t>(z) * nx + x] : 0.0f;
}

// dminus[i] = C1 (f[i] - f[i-1]) - C2 (f[i+1] - f[i-2]), along z or x.
__device__ __forceinline__ float dz_minus(const float* f, int z, int x,
                                          int nz, int nx) {
  return kC1 * (at(f, z, x, nz, nx) - at(f, z - 1, x, nz, nx)) -
         kC2 * (at(f, z + 1, x, nz, nx) - at(f, z - 2, x, nz, nx));
}

__device__ __forceinline__ float dz_plus(const float* f, int z, int x,
                                         int nz, int nx) {
  return kC1 * (at(f, z + 1, x, nz, nx) - at(f, z, x, nz, nx)) -
         kC2 * (at(f, z + 2, x, nz, nx) - at(f, z - 1, x, nz, nx));
}

__device__ __forceinline__ float dx_minus(const float* f, int z, int x,
                                          int nz, int nx) {
  return kC1 * (at(f, z, x, nz, nx) - at(f, z, x - 1, nz, nx)) -
         kC2 * (at(f, z, x + 1, nz, nx) - at(f, z, x - 2, nz, nx));
}

__device__ __forceinline__ float dx_plus(const float* f, int z, int x,
                                         int nz, int nx) {
  return kC1 * (at(f, z, x + 1, nz, nx) - at(f, z, x, nz, nx)) -
         kC2 * (at(f, z, x + 2, nz, nx) - at(f, z, x - 1, nz, nx));
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
  const float* vz = plane(p, VZ, s);
  const float* vx = plane(p, VX, s);
  const float* pz = p.prof_z;
  const float* px = p.prof_x;

  const float d_vz = dz_minus(vz, z, x, nz, nx);
  float* psi = plane(p, P_VZ_DZ, s) + c;
  const float p_vz_dz = pz[B * nz + z] * *psi + pz[A * nz + z] * d_vz;
  *psi = p_vz_dz;
  const float dvz = d_vz * pz[IK * nz + z] + p_vz_dz;

  const float d_vx = dx_minus(vx, z, x, nz, nx);
  psi = plane(p, P_VX_DX, s) + c;
  const float p_vx_dx = px[B * nx + x] * *psi + px[A * nx + x] * d_vx;
  *psi = p_vx_dx;
  const float dvx = d_vx * px[IK * nx + x] + p_vx_dx;

  const float d_vxz = dz_plus(vx, z, x, nz, nx);
  psi = plane(p, P_VX_DZ, s) + c;
  const float p_vx_dz = pz[B_H * nz + z] * *psi + pz[A_H * nz + z] * d_vxz;
  *psi = p_vx_dz;
  const float dvxz = d_vxz * pz[IK_H * nz + z] + p_vx_dz;

  const float d_vzx = dx_plus(vz, z, x, nz, nx);
  psi = plane(p, P_VZ_DX, s) + c;
  const float p_vz_dx = px[B_H * nx + x] * *psi + px[A_H * nx + x] * d_vzx;
  *psi = p_vz_dx;
  const float dvzx = d_vzx * px[IK_H * nx + x] + p_vz_dx;

  float* szz = plane(p, SZZ, s) + c;
  float* sxx = plane(p, SXX, s) + c;
  float* sxz = plane(p, SXZ, s) + c;
  if (z >= 2 && z <= nz - 3 && x >= 2 && x <= nx - 3) {
    const float lam = p.mats[LAM * plane_n + c];
    const float lp2m = p.mats[LP2M * plane_n + c];
    *szz += (lp2m * dvz + lam * dvx) * p.dt;
    *sxx += (lam * dvz + lp2m * dvx) * p.dt;
    *sxz += p.mats[AVE_MU * plane_n + c] * (dvxz + dvzx) * p.dt;
  }
  if (z == p.src_z[s] && x == p.src_x[s]) {
    const float amp = p.src_amp * p.stf[static_cast<size_t>(s) * p.nt + it];
    *szz += amp;
    *sxx += p.rxz[s] * amp;
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
  const float* szz = plane(p, SZZ, s);
  const float* sxx = plane(p, SXX, s);
  const float* sxz = plane(p, SXZ, s);
  const float* pz = p.prof_z;
  const float* px = p.prof_x;

  const float d_szz = dz_plus(szz, z, x, nz, nx);
  float* psi = plane(p, P_SZZ_DZ, s) + c;
  const float p_szz_dz = pz[B_H * nz + z] * *psi + pz[A_H * nz + z] * d_szz;
  *psi = p_szz_dz;
  const float dszz = d_szz * pz[IK_H * nz + z] + p_szz_dz;

  const float d_sxzx = dx_minus(sxz, z, x, nz, nx);
  psi = plane(p, P_SXZ_DX, s) + c;
  const float p_sxz_dx = px[B * nx + x] * *psi + px[A * nx + x] * d_sxzx;
  *psi = p_sxz_dx;
  const float dsxzx = d_sxzx * px[IK * nx + x] + p_sxz_dx;

  const float d_sxzz = dz_minus(sxz, z, x, nz, nx);
  psi = plane(p, P_SXZ_DZ, s) + c;
  const float p_sxz_dz = pz[B * nz + z] * *psi + pz[A * nz + z] * d_sxzz;
  *psi = p_sxz_dz;
  const float dsxzz = d_sxzz * pz[IK * nz + z] + p_sxz_dz;

  const float d_sxx = dx_plus(sxx, z, x, nz, nx);
  psi = plane(p, P_SXX_DX, s) + c;
  const float p_sxx_dx = px[B_H * nx + x] * *psi + px[A_H * nx + x] * d_sxx;
  *psi = p_sxx_dx;
  const float dsxx = d_sxx * px[IK_H * nx + x] + p_sxx_dx;

  if (z >= 2 && z <= nz - 3 && x >= 2 && x <= nx - 3) {
    plane(p, VZ, s)[c] +=
        (dszz + dsxzx) * p.mats[BYC_A * plane_n + c] * p.dt;
    plane(p, VX, s)[c] +=
        (dsxzz + dsxx) * p.mats[BYC_B * plane_n + c] * p.dt;
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
  const float* vz = plane(p, VZ, s);
  const float* vx = plane(p, VX, s);
  const float pr = plane(p, SZZ, s)[c] + plane(p, SXX, s)[c];
  // ett is not divided by the spacing (recording_exx / recording_ezz)
  const float ett = p.ett_ezz ? vz[c] - vz[c - nx] : vx[c] - vx[c - 1];
  const size_t ch = static_cast<size_t>(p.n_rec) * p.nt;
  float* out = p.data + static_cast<size_t>(s) * 4 * ch +
               static_cast<size_t>(r) * p.nt + it + 1;
  out[0] = pr;
  out[ch] = vx[c];
  out[2 * ch] = vz[c];
  out[3 * ch] = ett;
}

}  // namespace

// Runs all nt-1 steps for all shots on `stream`; returns the first CUDA
// error (0 on success).  Does not synchronise and allocates nothing: the
// caller passes a zeroed state and a zeroed data buffer.
extern "C" int elastic_forward(const float* mats, const float* prof_z,
                               const float* prof_x, const float* stf,
                               const int* src_z, const int* src_x,
                               const float* rxz, float* state, float* data,
                               int S, int nz, int nx, int nt, int rec_row,
                               int rec_x0, int n_rec, int ett_ezz, float dt,
                               float src_amp, void* stream) {
  Params p{mats, prof_z, prof_x, stf, src_z, src_x, rxz, state, data,
           S, nz, nx, nt, rec_row, rec_x0, n_rec, ett_ezz, dt, src_amp};
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
    record_kernel<<<rec_blocks, kRecThreads, 0, st>>>(p, it);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Message for an error code returned by elastic_forward.
extern "C" const char* elastic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
