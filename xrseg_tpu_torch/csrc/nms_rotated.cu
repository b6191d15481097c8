// Greedy probIoU select-and-suppress NMS for rotated boxes (the OBB task)
// on Hopper (sm_90a): one thread block per image.
//
// Replaces the TPU kernel xrseg_tpu/ops/pallas_kernels.py
// nms_rotated_batched_pallas (K3; body _nms_rotated_batched_kernel). For
// each image it runs max_det greedy steps over K candidates:
//
//   m, i  = max of the masked scores, ties to the LOWEST index
//   ok    = m > NEG * 0.5                      (NEG = float32 min)
//   iou_k = probIoU(k, i) from the boxes' Gaussian terms
//   every k with iou_k > thr, and i itself, gets score NEG (only while ok)
//   idx[t] = i, ok[t] = ok
//
// Inputs: rows [B, 6, K] f32, per image the rows x, y (class offset
// applied to both), a, b, c (the covariance terms) and det = max(ab - c^2,
// 0), computed outside the kernel by ops/nms_kernels.rotated_gaussian_rows;
// masked scores [B, K] f32 (below the score gate = NEG). Outputs: idx
// [B, max_det] int32, ok [B, max_det] bool.
//
// What bounds it on this card: the data is 7 * K * 4 bytes per image (602
// KB at K = 21504, the anchors of a 1024x1024 input) read once, and the
// work about 45 operations per candidate per step, among them a division
// pair, a log, an exp and two square roots. The 50 steps are a serial chain
// of block-wide reductions, so at small B the kernel is bound by the
// latency of each step and uses B of the card's 132 SMs.
//
// What the design does about it: the 602 KB do not fit a block's 227 KB
// of shared memory, so only the masked scores live there (86 KB at
// K = 21504), updated in place; each step reads the six read-only geometry
// rows through the read-only cache (__ldg), and they stay in the 50 MB L2
// across steps. A candidate already at NEG skips the overlap math (it can
// only be set to NEG again), so late steps touch only live candidates. The
// step's argmax is K1's (nms_common.cuh). Once ok turns false the rest of
// the slate is filled and the block exits.
//
// Exactness: idx/ok must equal the plain torch loop
// (ops/nms_kernels.nms_rotated_batched_torch) bit for bit on the card. The
// overlap row keeps the operation order of the TPU kernel
// (pallas_kernels.py:360-367) and of the plain version, with
// round-to-nearest intrinsics for + - * / and sqrt, and logf/expf (what
// torch's CUDA log/exp call; never the __logf/__expf approximations). The
// file is built with -fmad=false. eps is passed in as the float32 value the
// plain version uses. The clamps let NaN through, as torch.clamp does.

#include <cuda_runtime.h>

#include "nms_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

// torch.clamp_min(v, 0): NaN stays NaN
__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

// torch.clamp(v, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Gauss {
  float x, y, a, b, c, det;
};

__device__ __forceinline__ Gauss load(const float* g, int K, int k) {
  return {__ldg(g + k), __ldg(g + K + k), __ldg(g + 2 * K + k),
          __ldg(g + 3 * K + k), __ldg(g + 4 * K + k), __ldg(g + 5 * K + k)};
}

// probIoU of the selected box s against candidate q, in the plain version's
// operation order.
__device__ __forceinline__ float probiou(const Gauss& s, const Gauss& q,
                                         float eps) {
  const float sa = __fadd_rn(s.a, q.a);
  const float sb = __fadd_rn(s.b, q.b);
  const float sc = __fadd_rn(s.c, q.c);
  const float dy = __fsub_rn(s.y, q.y);            // yi - y
  const float dx = __fsub_rn(s.x, q.x);            // xi - x
  const float denom = __fadd_rn(
      clamp0(__fsub_rn(__fmul_rn(sa, sb), __fmul_rn(sc, sc))), eps);
  const float t1 = __fmul_rn(
      __fdiv_rn(__fadd_rn(__fmul_rn(sa, __fmul_rn(dy, dy)),
                          __fmul_rn(sb, __fmul_rn(dx, dx))),
                denom),
      0.25f);
  const float t2 = __fmul_rn(
      __fdiv_rn(__fmul_rn(__fmul_rn(sc, __fsub_rn(q.x, s.x)), dy), denom),
      0.5f);
  const float root = __fsqrt_rn(clamp0(__fmul_rn(s.det, q.det)));
  const float t3 = __fmul_rn(
      0.5f, logf(__fadd_rn(
                __fdiv_rn(denom, __fadd_rn(__fmul_rn(4.f, root), eps)), eps)));
  const float bd = clamp(__fadd_rn(__fadd_rn(t1, t2), t3), eps, 100.f);
  return __fsub_rn(1.f, __fsqrt_rn(__fadd_rn(__fsub_rn(1.f, expf(-bd)), eps)));
}

__global__ void __launch_bounds__(kMaxThreads)
nms_rotated_kernel(const float* __restrict__ rows,
                   const float* __restrict__ scores, int K, float thr,
                   float eps, int max_det, int* __restrict__ idx_out,
                   bool* __restrict__ ok_out) {
  extern __shared__ float sm[];                // masked scores, updated
  const int b = blockIdx.x;
  const float* g = rows + static_cast<size_t>(b) * 6 * K;
  const float* s = scores + static_cast<size_t>(b) * K;
  int* idx = idx_out + static_cast<size_t>(b) * max_det;
  bool* okp = ok_out + static_cast<size_t>(b) * max_det;
  for (int k = threadIdx.x; k < K; k += blockDim.x) sm[k] = s[k];
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
    const Gauss sel = load(g, K, i);
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      if (sm[k] == kNeg) continue;             // suppressed or below the gate
      if (k == i || probiou(sel, load(g, K, k), eps) > thr) sm[k] = kNeg;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Largest K the kernel takes: the one whose masked scores fit the block's
// shared memory.
int xrseg_nms_rotated_max_k(int device) { return scores_max_k(device); }

// Launches one block per image on `stream`; returns cudaGetLastError().
int xrseg_nms_rotated(const void* rows, const void* scores, int B, int K,
                      float thr, float eps, int max_det, void* idx, void* ok,
                      void* stream) {
  if (B <= 0 || max_det <= 0) return 0;
  const long long budget = smem_budget();
  if (budget < 0) return static_cast<int>(-budget);
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  if (static_cast<long long>(smem) > budget)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      nms_rotated_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int threads = (K + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  nms_rotated_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(scores), K,
      thr, eps, max_det, static_cast<int*>(idx), static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

const char* xrseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
