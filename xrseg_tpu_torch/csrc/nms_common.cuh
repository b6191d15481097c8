// Pieces shared by the greedy NMS kernels (nms_select.cu, nms_rotated.cu):
// the masked-score sentinel, the block-wide argmax with the plain
// versions' tie-break, and the shared-memory budget of one block.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -FLT_MAX;               // float32 min
constexpr size_t kStaticSmemReserve = 1024;    // reduction scratch + margin

__device__ __forceinline__ void take_better(float& v, int& k, float ov,
                                            int ok) {
  if (ov > v || (ov == v && ok < k)) {
    v = ov;
    k = ok;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& k) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int ok = __shfl_down_sync(0xffffffffu, k, off);
    take_better(v, k, ov, ok);
  }
}

// Largest of sm[0, K) and its index, ties to the LOWEST index, returned to
// every thread of the block. Call it from every thread, after the
// __syncthreads() that fences the last write to sm.
__device__ __forceinline__ float block_argmax(const float* sm, int K,
                                              int& best) {
  __shared__ float red_v[32];
  __shared__ int red_k[32];
  __shared__ float best_v;
  __shared__ int best_k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  // strided pass: ascending k, so '>' keeps the lowest index on ties
  float v = -INFINITY;
  int kk = K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float x = sm[k];
    if (x > v) {
      v = x;
      kk = k;
    }
  }
  warp_argmax(v, kk);
  if (lane == 0) {
    red_v[warp] = v;
    red_k[warp] = kk;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? red_v[lane] : -INFINITY;
    kk = lane < nwarps ? red_k[lane] : K;
    warp_argmax(v, kk);
    if (lane == 0) {
      best_v = v;
      best_k = kk;
    }
  }
  __syncthreads();
  best = best_k;
  return best_v;
}

// The block's opt-in shared-memory limit in bytes, 0 if it cannot be read.
inline int optin_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return optin;
}

// Largest K whose masked scores fit a block's shared memory on `device`.
inline int scores_max_k(int device) {
  const int optin = optin_smem(device);
  if (optin <= static_cast<int>(kStaticSmemReserve)) return 0;
  return static_cast<int>((optin - kStaticSmemReserve) / sizeof(float));
}

// Shared memory left for a kernel's dynamic rows on the current device, or
// a negative CUDA error code.
inline long long smem_budget() {
  int device = 0;
  const cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  const int optin = optin_smem(device);
  if (optin <= static_cast<int>(kStaticSmemReserve))
    return -static_cast<long long>(cudaErrorInvalidValue);
  return optin - static_cast<long long>(kStaticSmemReserve);
}

}  // namespace
