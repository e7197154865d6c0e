// The shot sum of both backwards, one body for elastic_bwd.cu
// (sum_shots_kernel, the gradients of 5 material planes) and acoustic_bwd.cu
// (ac_sum_shots_kernel, the gradients of 3 planes, or the image and the
// illumination): out[c] = the sum over s = 0 .. S-1, in that order, of
// per_shot[s * n + c], for c < n.  Each output is 0.0f + g[0] + g[1] +
// ..., the bits of a plain loop over shots; no atomics, no tree.  Each file
// keeps its own named __global__ entry, which calls sum_shots below with
// its own number of shots a group.
//
// Replaces the sum over shots that the TPU kernels carry in VMEM across
// their sequential shot axis (pallas_engine.py::_run_backward, pallas_call
// at line 1186, and _ac_run_backward, line 1746; pallas_stream.py's K4 and
// K8 at lines 1794 and 2493): here the shots run in parallel blocks, so
// the per-shot planes are summed by a last launch.
//
// What bounds it on this card: bytes (the per-shot planes read once, the
// sum written once; one add an input).  So a thread keeps many loads in
// flight: it owns 4 outputs of a tile of 4 kThreads, and starts the loads
// of kGroup shots before it adds any of them.  The per-shot planes are read
// evict-first (__ldcs), since they are dead after the sum (plain loads were
// slower inside a backward, PERF.md, PR 11).  kVec: a thread's 4 outputs
// are consecutive and read and written as one float4, which needs n a
// multiple of 4 and both planes 16-byte aligned (aligned); otherwise they
// lie kThreads apart, so that a warp's 4-byte accesses stay coalesced.  The
// grid is at most the blocks of the entry that every SM holds at once,
// striding over the tiles.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace shot_sum {

constexpr int kThreads = 256;
constexpr int kTile = 4 * kThreads;  // outputs a block a pass

template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ a,
                                        size_t c, size_t n) {
  if (kVec) return __ldcs(reinterpret_cast<const float4*>(a + c));
  float4 v;
  v.x = __ldcs(a + c);
  v.y = c + kThreads < n ? __ldcs(a + c + kThreads) : 0.0f;
  v.z = c + 2 * kThreads < n ? __ldcs(a + c + 2 * kThreads) : 0.0f;
  v.w = c + 3 * kThreads < n ? __ldcs(a + c + 3 * kThreads) : 0.0f;
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ a, size_t c,
                                       size_t n, float4 v) {
  if (kVec) {
    *reinterpret_cast<float4*>(a + c) = v;
    return;
  }
  a[c] = v.x;
  if (c + kThreads < n) a[c + kThreads] = v.y;
  if (c + 2 * kThreads < n) a[c + 2 * kThreads] = v.z;
  if (c + 3 * kThreads < n) a[c + 3 * kThreads] = v.w;
}

// out (n) = the sum over s = 0 .. S-1, in that order, of per_shot + s * n
// (n each), run by every thread of a grid of kThreads-thread blocks.
template <bool kVec, int kGroup>
__device__ __forceinline__ void sum_shots(const float* __restrict__ per_shot,
                                          float* __restrict__ out, size_t n,
                                          int S) {
  for (size_t base = blockIdx.x * static_cast<size_t>(kTile); base < n;
       base += gridDim.x * static_cast<size_t>(kTile)) {
    // this thread's first output; the tile's last may be ragged
    const size_t c = base + (kVec ? 4 * threadIdx.x : threadIdx.x);
    if (c >= n) continue;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s0 = 0; s0 < S; s0 += kGroup) {
      float4 v[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (s0 + g < S) {
          v[g] = load4<kVec>(per_shot + static_cast<size_t>(s0 + g) * n, c,
                             n);
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (s0 + g < S) {
          acc.x += v[g].x;
          acc.y += v[g].y;
          acc.z += v[g].z;
          acc.w += v[g].w;
        }
      }
    }
    store4<kVec>(out, c, n, acc);
  }
}

// Whether per_shot (S planes of n) and out (n) can be read and written as
// float4s.
inline bool aligned(const float* per_shot, const float* out, size_t n) {
  return n % 4 == 0 && reinterpret_cast<uintptr_t>(per_shot) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// Launches `kernel` (an entry that runs sum_shots) on `st` over the tiles
// of n outputs: at most the blocks of it that the current device's SMs hold
// at once, found once a process into *grid (a grid of another size gives
// the same bits).  Returns the CUDA error (0 on success).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int* grid, size_t n, cudaStream_t st,
           Args... args) {
  if (*grid == 0) {
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    *grid = sms * per_sm;
  }
  const size_t tiles = (n + kTile - 1) / kTile;
  const int blocks = static_cast<int>(
      tiles < static_cast<size_t>(*grid) ? tiles : *grid);
  kernel<<<blocks, kThreads, 0, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace shot_sum
