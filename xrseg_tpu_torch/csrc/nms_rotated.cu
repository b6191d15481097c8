// Greedy probIoU select-and-suppress NMS for rotated boxes (the OBB task)
// on Hopper (sm_90a): one image on one thread-block cluster.
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
// What bounds it on this card: the data is 28 bytes a candidate per image
// (602 KB at K = 21504, the anchors of a 1024x1024 input) read once, and
// the work about 45 operations per candidate per step, among them a
// division pair, a log, an exp and two square roots. The 50 steps are a
// serial chain of reductions and barriers: the kernel is bound by the
// latency of one step, and by how many of the card's 132 SMs one image can
// use.
//
// What the design does about it (the loop itself is nms_common.cuh's): the
// 602 KB do not fit one block's 227 KB of shared memory, but they fit a
// cluster's: an image runs on up to 8 blocks on 8 SMs, and each block keeps
// all seven rows of its slice resident (75 KB a block at K = 21504), so a
// step reads no device memory at any K the cluster holds (65824 on an
// H100). A step is one pass over the 3 candidates a thread owns, which
// writes the suppressions and keeps the best survivor for the next step;
// two redux.sync per warp and one block barrier; then each block sends its
// winner, Gaussian terms included, into every block's shared memory with
// st.async and waits on its own mbarrier for the 8 offers: no cluster-wide
// barrier. A candidate already at NEG skips the overlap math (it can only
// be set to NEG again), so late steps compute only live candidates. Once ok
// turns false the rest of the slate is filled and the cluster leaves.
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

// torch.clamp_min(v, 0): NaN stays NaN
__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

// torch.clamp(v, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Gauss {
  float x, y, a, b, c, det;
};

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

struct Rotated {
  using Box = Gauss;
  using Selected = Gauss;
  static constexpr int kFloats = 6;
  float eps;

  // the image's rows are [6, K] in device memory and [6, S] in the block
  __device__ static __forceinline__ Box from_global(const float* g, int K,
                                                    int k) {
    return {__ldg(g + k),         __ldg(g + K + k),     __ldg(g + 2 * K + k),
            __ldg(g + 3 * K + k), __ldg(g + 4 * K + k), __ldg(g + 5 * K + k)};
  }
  __device__ static __forceinline__ void put(float* rows, int S, int j,
                                             const Box& q) {
    rows[j] = q.x;
    rows[S + j] = q.y;
    rows[2 * S + j] = q.a;
    rows[3 * S + j] = q.b;
    rows[4 * S + j] = q.c;
    rows[5 * S + j] = q.det;
  }
  __device__ static __forceinline__ Box get(const float* rows, int S, int j) {
    return {rows[j],         rows[S + j],     rows[2 * S + j],
            rows[3 * S + j], rows[4 * S + j], rows[5 * S + j]};
  }
  __device__ __forceinline__ float overlap(const Gauss& s,
                                           const Gauss& q) const {
    return probiou(s, q, eps);
  }
};

}  // namespace

extern "C" {

// The current card's SM count, a block's opt-in shared-memory bytes, and
// room[0..3]: the clusters of 1, 2, 4 and 8 blocks that it runs at once
// with an SM to each block. Returns a CUDA error code.
int xrseg_nms_rotated_limits(int* sm_count, int* smem_optin, int* room) {
  return card_limits<Rotated>(sm_count, smem_optin, room);
}

// Launches B clusters of `cluster` blocks of `threads` threads, one cluster
// per image, on `stream`. The plan comes from the caller; a plan the kernel
// cannot run, or the card cannot place, returns a CUDA error code.
int xrseg_nms_rotated(const void* rows, const void* scores, int B, int K,
                      float thr, float eps, int max_det, void* idx, void* ok,
                      int cluster, int threads, int smem_bytes,
                      void* stream) {
  return launch(rows, scores, B, K, thr, Rotated{eps}, max_det, idx, ok,
                cluster, threads, smem_bytes, stream);
}

}  // extern "C"
