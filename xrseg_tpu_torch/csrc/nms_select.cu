// Greedy select-and-suppress NMS on axis-aligned boxes for Hopper (sm_90a):
// one image on one thread-block cluster.
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
// What bounds it on this card: the data is small (20 bytes a candidate read
// once, 168 KB an image at K = 8400) and the work light (about 20 flops per
// candidate per step), but the 50 steps form a serial chain of reductions
// and barriers: the kernel is bound by the latency of one step, and by how
// many of the card's 132 SMs one image can use.
//
// What the design does about it (the loop itself is nms_common.cuh's): an
// image runs on a cluster of up to 8 blocks on 8 SMs; each block keeps its
// slice of the candidates in shared memory, the four corners of a
// candidate as one float4 (21 KB a block at K = 8400 on 8 blocks, 54 KB at
// K = 21504), so a step reads no device memory at any K the cluster holds
// (92160 on an H100). A step is one pass over the 2-3 candidates a thread
// owns, which writes the suppressions and keeps the best survivor for the
// next step; two redux.sync per warp and one block barrier; then each
// block sends its winner, corners included, into every block's shared
// memory with st.async and waits on its own mbarrier for the 8 offers: no
// cluster-wide barrier. Up to 1024 candidates (the pre_topk-compacted
// case) an image takes one block and a step has the one block barrier
// only. Candidates that do not intersect the selected box at all (most of
// them) leave the IoU before its division. Once ok turns false the rest of
// the slate is filled and the cluster leaves.
//
// Exactness: the results must equal the plain torch loop
// (xrseg_tpu_torch/ops/nms_kernels.py) bit for bit. The IoU arithmetic is
// written with round-to-nearest intrinsics (no FMA contraction, IEEE
// division) and the file is also built with -fmad=false; area is
// recomputed from the corners exactly as the plain version computes it.

#include <cuda_runtime.h>

#include "nms_common.cuh"

namespace {

__device__ __forceinline__ float box_area(const float4& c) {
  return __fmul_rn(fmaxf(__fsub_rn(c.z, c.x), 0.f),
                   fmaxf(__fsub_rn(c.w, c.y), 0.f));
}

struct AxisAligned {
  using Box = float4;                          // x1, y1, x2, y2
  static constexpr int kFloats = 4;

  struct Selected {
    float4 c;
    float area;
    __device__ explicit Selected(const float4& box)
        : c(box), area(box_area(box)) {}
  };

  __device__ static __forceinline__ Box from_global(const float* g, int,
                                                    int k) {
    return __ldg(reinterpret_cast<const float4*>(g) + k);
  }
  __device__ static __forceinline__ void put(float* rows, int, int j,
                                             const Box& box) {
    reinterpret_cast<float4*>(rows)[j] = box;
  }
  __device__ static __forceinline__ Box get(const float* rows, int, int j) {
    return reinterpret_cast<const float4*>(rows)[j];
  }

  // IoU of the selected box against candidate q, in the plain version's
  // operation order.
  __device__ __forceinline__ float overlap(const Selected& s,
                                           const Box& q) const {
    const float iw =
        fmaxf(__fsub_rn(fminf(q.z, s.c.z), fmaxf(q.x, s.c.x)), 0.f);
    const float ih =
        fmaxf(__fsub_rn(fminf(q.w, s.c.w), fmaxf(q.y, s.c.y)), 0.f);
    const float inter = __fmul_rn(iw, ih);
    // no overlap: the ratio is 0 whatever the union is (0 / uni, or the
    // uni <= 0 case), so most candidates never reach the division
    if (!(inter > 0.f)) return 0.f;
    const float uni = __fsub_rn(__fadd_rn(box_area(q), s.area), inter);
    return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
  }
};

}  // namespace

extern "C" {

// The current card's SM count, a block's opt-in shared-memory bytes, and
// room[0..3]: the clusters of 1, 2, 4 and 8 blocks that it runs at once
// with an SM to each block. Returns a CUDA error code.
int xrseg_nms_select_limits(int* sm_count, int* smem_optin, int* room) {
  return card_limits<AxisAligned>(sm_count, smem_optin, room);
}

// Launches B clusters of `cluster` blocks of `threads` threads, one cluster
// per image, on `stream`. The plan comes from the caller; a plan the kernel
// cannot run, or the card cannot place, returns a CUDA error code.
int xrseg_nms_select(const void* corners, const void* scores, int B, int K,
                     float thr, int max_det, void* idx, void* ok, int cluster,
                     int threads, int smem_bytes, void* stream) {
  return launch(corners, scores, B, K, thr, AxisAligned{}, max_det, idx, ok,
                cluster, threads, smem_bytes, stream);
}

}  // extern "C"
