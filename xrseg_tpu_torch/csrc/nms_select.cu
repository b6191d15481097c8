// Greedy select-and-suppress NMS for Hopper (sm_90a): one thread block per image.
//
// Replaces the TPU kernels xrseg_tpu/ops/pallas_kernels.py
// nms_select_batched_pallas (K1, grid = B images) and nms_select_pallas
// (K2, one image, launched here with B = 1). For each image it runs
// max_det greedy steps over K candidates:
//
//   m, i  = max of the masked scores, ties to the LOWEST index
//   ok    = m > NEG * 0.5                      (NEG = float32 min)
//   iou_k = inter(k, i) / union(k, i), 0 where union <= 0
//   every k with iou_k > thr, and i itself, gets score NEG (only while ok)
//   idx[t] = i, ok[t] = ok
//
// Inputs: corners [B, K, 4] f32 (x1, y1, x2, y2, class offset applied),
// masked scores [B, K] f32 (below the score gate = NEG). Outputs: idx
// [B, max_det] int32, ok [B, max_det] bool.
//
// What bounds it on this card: the data is small (5 * K * 4 bytes read
// once per image, 168 KB at K = 8400) and the work light (about 20 flops
// per candidate per step), but the 50 steps form a serial chain of
// block-wide reductions and barriers, so at small B the kernel is bound by
// latency and uses B of the card's 132 SMs.
//
// What the design does about it: all of an image's candidates stay in
// shared memory for the whole loop (dynamic shared memory above 48 KB, set
// with cudaFuncSetAttribute), so each step touches no device memory; the
// whole batch is one launch; a step is one strided pass for the local
// argmax, a warp-shuffle reduction, one cross-warp reduction, and one
// strided pass that writes the suppressions. Once ok turns false the rest
// of the slate is filled and the block exits.
//
// Exactness: the results must equal the plain torch loop
// (xrseg_tpu_torch/ops/nms_kernels.py) bit for bit. The IoU arithmetic is
// written with round-to-nearest intrinsics (no FMA contraction, IEEE
// division) and the file is also built with -fmad=false; area is
// recomputed from the corners exactly as the plain version computes it.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
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

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f),
                   fmaxf(__fsub_rn(y2, y1), 0.f));
}

__global__ void __launch_bounds__(kMaxThreads)
nms_select_kernel(const float* __restrict__ corners,
                  const float* __restrict__ scores, int K, float thr,
                  int max_det, int* __restrict__ idx_out,
                  bool* __restrict__ ok_out) {
  extern __shared__ float smem[];
  float* sx1 = smem;
  float* sy1 = sx1 + K;
  float* sx2 = sy1 + K;
  float* sy2 = sx2 + K;
  float* sm = sy2 + K;                         // masked scores, updated
  __shared__ float red_v[32];
  __shared__ int red_k[32];
  __shared__ float best_v;
  __shared__ int best_k;

  const int b = blockIdx.x;
  const float* c = corners + static_cast<size_t>(b) * K * 4;
  const float* s = scores + static_cast<size_t>(b) * K;
  int* idx = idx_out + static_cast<size_t>(b) * max_det;
  bool* okp = ok_out + static_cast<size_t>(b) * max_det;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    sx1[k] = c[4 * k];
    sy1[k] = c[4 * k + 1];
    sx2[k] = c[4 * k + 2];
    sy2[k] = c[4 * k + 3];
    sm[k] = s[k];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;

  for (int t = 0; t < max_det; ++t) {
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
    const int i = best_k;
    const bool ok = best_v > kNeg * 0.5f;
    if (threadIdx.x == 0) {
      idx[t] = i;
      okp[t] = ok;
    }
    if (!ok) {
      // nothing is suppressed any more: every later step repeats this one
      for (int u = t + 1 + threadIdx.x; u < max_det; u += blockDim.x) {
        idx[u] = i;
        okp[u] = false;
      }
      return;                                  // uniform across the block
    }
    const float bx1 = sx1[i], by1 = sy1[i], bx2 = sx2[i], by2 = sy2[i];
    const float barea = box_area(bx1, by1, bx2, by2);
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const float x1 = sx1[k], y1 = sy1[k], x2 = sx2[k], y2 = sy2[k];
      const float iw = fmaxf(__fsub_rn(fminf(x2, bx2), fmaxf(x1, bx1)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(y2, by2), fmaxf(y1, by1)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float uni =
          __fsub_rn(__fadd_rn(box_area(x1, y1, x2, y2), barea), inter);
      const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
      if (iou > thr || k == i) sm[k] = kNeg;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Largest K whose five per-candidate rows fit the block's shared memory.
int xrseg_nms_select_max_k(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return static_cast<int>((optin - kStaticSmemReserve) / (5 * sizeof(float)));
}

// Launches one block per image on `stream`; returns cudaGetLastError().
int xrseg_nms_select(const void* corners, const void* scores, int B, int K,
                     float thr, int max_det, void* idx, void* ok,
                     void* stream) {
  if (B <= 0 || max_det <= 0) return 0;
  const size_t smem = static_cast<size_t>(5) * K * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      nms_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int threads = (K + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  nms_select_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(corners), static_cast<const float*>(scores), K,
      thr, max_det, static_cast<int*>(idx), static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

const char* xrseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
