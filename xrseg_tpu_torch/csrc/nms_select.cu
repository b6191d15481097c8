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
// What the design does about it: the batch is one launch; a step is
// one strided pass for the local argmax, a warp-shuffle reduction, one
// cross-warp reduction, and one strided pass that writes the
// suppressions. Once ok turns false the rest of the slate is filled and
// the block exits. Where the candidates live depends on K (one
// __global__, templated on it; the launcher picks the variant):
//   - all five rows fit the block's shared memory (K <= ~11.6k on an H100,
//     e.g. 8400 anchors at 640x640): every row is copied there once and a
//     step touches no device memory;
//   - otherwise (21504 anchors at 1024x1024 need 430 KB): only the masked
//     scores live in shared memory (86 KB at K = 21504), and each step
//     reads the four read-only corner rows through the read-only cache
//     (__ldg); 344 KB per image stays resident in the 50 MB L2.
// The arithmetic and the tie-breaking are the same in both variants.
//
// Exactness: the results must equal the plain torch loop
// (xrseg_tpu_torch/ops/nms_kernels.py) bit for bit. The IoU arithmetic is
// written with round-to-nearest intrinsics (no FMA contraction, IEEE
// division) and the file is also built with -fmad=false; area is
// recomputed from the corners exactly as the plain version computes it.

#include <cuda_runtime.h>

#include "nms_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f),
                   fmaxf(__fsub_rn(y2, y1), 0.f));
}

// The candidates' corner rows: copied to shared memory, or read in place.
template <bool kInSmem>
struct Corners;

template <>
struct Corners<true> {
  const float *x1, *y1, *x2, *y2;
  __device__ Corners(const float* c, float* smem, int K) {
    float* sx1 = smem + K;                     // smem[0, K) holds the scores
    float* sy1 = sx1 + K;
    float* sx2 = sy1 + K;
    float* sy2 = sx2 + K;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      sx1[k] = c[4 * k];
      sy1[k] = c[4 * k + 1];
      sx2[k] = c[4 * k + 2];
      sy2[k] = c[4 * k + 3];
    }
    x1 = sx1;
    y1 = sy1;
    x2 = sx2;
    y2 = sy2;
  }
  __device__ __forceinline__ void get(int k, float& a, float& b, float& cc,
                                      float& d) const {
    a = x1[k];
    b = y1[k];
    cc = x2[k];
    d = y2[k];
  }
};

template <>
struct Corners<false> {
  const float* c;
  __device__ Corners(const float* cp, float*, int) : c(cp) {}
  __device__ __forceinline__ void get(int k, float& a, float& b, float& cc,
                                      float& d) const {
    a = __ldg(c + 4 * k);
    b = __ldg(c + 4 * k + 1);
    cc = __ldg(c + 4 * k + 2);
    d = __ldg(c + 4 * k + 3);
  }
};

template <bool kInSmem>
__global__ void __launch_bounds__(kMaxThreads)
nms_select_kernel(const float* __restrict__ corners,
                  const float* __restrict__ scores, int K, float thr,
                  int max_det, int* __restrict__ idx_out,
                  bool* __restrict__ ok_out) {
  extern __shared__ float smem[];
  float* sm = smem;                            // masked scores, updated
  const int b = blockIdx.x;
  const float* c = corners + static_cast<size_t>(b) * K * 4;
  const float* s = scores + static_cast<size_t>(b) * K;
  int* idx = idx_out + static_cast<size_t>(b) * max_det;
  bool* okp = ok_out + static_cast<size_t>(b) * max_det;
  for (int k = threadIdx.x; k < K; k += blockDim.x) sm[k] = s[k];
  const Corners<kInSmem> geo(c, smem, K);
  __syncthreads();

  for (int t = 0; t < max_det; ++t) {
    int i;
    const bool ok = block_argmax(sm, K, i) > kNeg * 0.5f;
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
    float bx1, by1, bx2, by2;
    geo.get(i, bx1, by1, bx2, by2);
    const float barea = box_area(bx1, by1, bx2, by2);
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      float x1, y1, x2, y2;
      geo.get(k, x1, y1, x2, y2);
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

template <bool kInSmem>
int launch(const float* corners, const float* scores, int B, int K, float thr,
           int max_det, int* idx, bool* ok, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      nms_select_kernel<kInSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int threads = (K + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  nms_select_kernel<kInSmem><<<B, threads, smem, stream>>>(
      corners, scores, K, thr, max_det, idx, ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest K the kernel takes: the one whose masked scores fit the block's
// shared memory (the corner rows are then read from device memory).
int xrseg_nms_select_max_k(int device) { return scores_max_k(device); }

// Launches one block per image on `stream`; returns cudaGetLastError().
// Takes the all-in-shared-memory variant when the five rows fit.
int xrseg_nms_select(const void* corners, const void* scores, int B, int K,
                     float thr, int max_det, void* idx, void* ok,
                     void* stream) {
  if (B <= 0 || max_det <= 0) return 0;
  const long long budget = smem_budget();
  if (budget < 0) return static_cast<int>(-budget);
  const long long all_rows = 5LL * K * sizeof(float);
  const auto* c = static_cast<const float*>(corners);
  const auto* s = static_cast<const float*>(scores);
  auto* i = static_cast<int*>(idx);
  auto* o = static_cast<bool*>(ok);
  auto st = static_cast<cudaStream_t>(stream);
  if (all_rows <= budget)
    return launch<true>(c, s, B, K, thr, max_det, i, o, all_rows, st);
  return launch<false>(c, s, B, K, thr, max_det, i, o,
                       static_cast<size_t>(K) * sizeof(float), st);
}

const char* xrseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
