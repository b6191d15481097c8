// Greedy weighted box fusion (WBF) over a score-sorted candidate stream on
// Hopper (sm_90a): K5 (axis-aligned boxes, IoU) and K6 (rotated boxes,
// probIoU, doubled-angle circular mean), one image per block.
//
// These are the port's own kernels. The JAX package has no Pallas kernel
// for WBF: it runs the merge as a lax.scan with one sequential step per
// candidate (xrseg_tpu/ops/wbf.py:90-136, rotated :188-227). In eager torch
// each step would be some 40 launches, so the scan runs here in one launch.
// For each image, over the candidates t = 0, 1, ... sorted by score,
// descending:
//
//   alive  = s_t > gate; the stream is sorted, so the alive candidates are
//            a prefix and the loop ends at the first dead one (a dead step
//            is an exact no-op of the JAX scan)
//   fused  = wsum / max(ssum, 1e-12) of every open cluster (K6: the angle
//            0.5 * atan2(sn, ssum > 0 ? cs : 1))
//   cand_d = cluster d is open, has the candidate's label (unless
//            class_aware is off) and overlap(candidate, fused_d) >= thr
//   if any cand: the cluster with the largest overlap, the LOWEST index on
//            ties (jnp.argmax), takes the candidate: wsum += s * box,
//            ssum += s, n += 1 (K6: cs += s cos 2a, sn += s sin 2a)
//   else if n_open < D: slot n_open opens with the candidate (top_i = its
//            anchor index, lab = its label) and n_open += 1
//   else the candidate is dropped
//
// Inputs, per image: boxes [B, K, 4] f32 (K6: [B, K, 5], the angle last),
// scores [B, K] f32, labels [B, K] int32 and order [B, K] int32 (each
// candidate's anchor index), all already sorted by score. Outputs: wsum
// [B, D, 4], ssum [B, D], n [B, D] int32, top_i [B, D] int32, lab [B, D]
// int32 (-1 where closed), active [B, D] bool, n_open [B] int32; K6 also
// cs, sn [B, D]. The final fuse and the score sort of the D clusters are
// plain torch outside the kernel (ops/wbf.py), as in JAX.
//
// What bounds it on this card: the steps are a serial chain, one per alive
// candidate (8400 at a 640x640 input, 21504 at 1024x1024, their multiples
// under TTA or an ensemble), each a max_det-wide overlap row and an
// argmax. The bytes are a few MB at most and the operations some 30 per
// cluster per step, far below the card's rates: the latency of one step
// bounds it, and an image can only use one SM's worth of the chain.
//
// What the design does about it: one block per image (the batch fills the
// SMs), one thread per cluster (D <= 1024), the cluster's sums and its
// fused box (K6: the fused box's Gaussian terms) held in the thread's
// registers; the fused box is recomputed only for the cluster that changed,
// which gives the numbers of JAX's recompute every step (the same
// expression on the same sums). A step reads the candidate (the same
// address in every thread), computes one overlap per thread, reduces the
// argmax with two redux.sync per warp, one block barrier and a second
// warp reduction of the warps' partials (double-buffered by step parity,
// so one barrier a step is enough), and then one thread merges or opens.
//
// Exactness: the outputs must equal the plain torch scan
// (ops/wbf.wbf_scan_plain, wbf_rotated_scan_plain) bit for bit on the card.
// The file is built with -fmad=false, and the arithmetic keeps the plain
// version's operation order with _rn intrinsics and the full-precision
// libm functions (atan2f, cosf, sinf, logf, expf). The thresholds come in
// as the float32 values the plain version compares against.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "nms_common.cuh"
#include "probiou.cuh"

namespace {

constexpr int kMaxClusters = kMaxThreads;      // one cluster a thread

__device__ __forceinline__ float max_lo(float v, float lo) {
  return v < lo ? lo : v;                      // clamp_min: NaN stays NaN
}

// ---- K5: axis-aligned boxes, IoU ----------------------------------------

struct AxisCand {
  float box[4];                                // cx, cy, w, h
  float x1, y1, x2, y2, area;
};

struct AxisOut {
  float* wsum;
  float* ssum;
  int* n;
  int* top_i;
  int* lab;
  bool* active;
  int* n_open;
};

struct Axis {
  static constexpr int kDim = 4;
  using Cand = AxisCand;
  using Out = AxisOut;

  // one cluster's sums and the corners and area of its fused box
  struct Cluster {
    float wsum[4] = {0.f, 0.f, 0.f, 0.f};
    float ssum = 0.f;
    float x1 = 0.f, y1 = 0.f, x2 = 0.f, y2 = 0.f, area = 0.f;

    __device__ void refresh() {
      const float den = max_lo(ssum, 1e-12f);
      const float cx = __fdiv_rn(wsum[0], den);
      const float cy = __fdiv_rn(wsum[1], den);
      const float hw = __fmul_rn(__fdiv_rn(wsum[2], den), 0.5f);
      const float hh = __fmul_rn(__fdiv_rn(wsum[3], den), 0.5f);
      x1 = __fsub_rn(cx, hw);
      y1 = __fsub_rn(cy, hh);
      x2 = __fadd_rn(cx, hw);
      y2 = __fadd_rn(cy, hh);
      area = __fmul_rn(clamp0(__fsub_rn(x2, x1)), clamp0(__fsub_rn(y2, y1)));
    }
    __device__ void open(float s, const Cand& c) {
      for (int i = 0; i < 4; ++i) wsum[i] = __fmul_rn(s, c.box[i]);
      ssum = s;
      refresh();
    }
    __device__ void merge(float s, const Cand& c) {
      for (int i = 0; i < 4; ++i)
        wsum[i] = __fadd_rn(wsum[i], __fmul_rn(s, c.box[i]));
      ssum = __fadd_rn(ssum, s);
      refresh();
    }
    // IoU of the candidate against the fused box (ops/wbf._iou_rows)
    __device__ float overlap(const Cand& c) const {
      const float iw = clamp0(__fsub_rn(fminf(c.x2, x2), fmaxf(c.x1, x1)));
      const float ih = clamp0(__fsub_rn(fminf(c.y2, y2), fmaxf(c.y1, y1)));
      const float inter = __fmul_rn(iw, ih);
      return __fdiv_rn(
          inter, max_lo(__fsub_rn(__fadd_rn(c.area, area), inter), 1e-12f));
    }
    __device__ void store(const Out& o, size_t at) const {
      for (int i = 0; i < 4; ++i) o.wsum[at * 4 + i] = wsum[i];
      o.ssum[at] = ssum;
    }
  };

  __device__ float overlap(const Cluster& cl, const Cand& c) const {
    return cl.overlap(c);
  }

  __device__ static Cand load(const float* g) {
    Cand c;
    for (int i = 0; i < 4; ++i) c.box[i] = __ldg(g + i);
    const float hw = __fmul_rn(c.box[2], 0.5f);
    const float hh = __fmul_rn(c.box[3], 0.5f);
    c.x1 = __fsub_rn(c.box[0], hw);
    c.y1 = __fsub_rn(c.box[1], hh);
    c.x2 = __fadd_rn(c.box[0], hw);
    c.y2 = __fadd_rn(c.box[1], hh);
    c.area = __fmul_rn(clamp0(__fsub_rn(c.x2, c.x1)),
                       clamp0(__fsub_rn(c.y2, c.y1)));
    return c;
  }
};

// ---- K6: rotated boxes, probIoU, doubled-angle circular mean -----------

struct RotCand {
  float box[4];                                // cx, cy, w, h
  float c2, s2;                                // cos 2a, sin 2a
  Gauss g;
};

struct RotOut {
  float* wsum;
  float* cs;
  float* sn;
  float* ssum;
  int* n;
  int* top_i;
  int* lab;
  bool* active;
  int* n_open;
};

struct Rot {
  static constexpr int kDim = 5;
  using Cand = RotCand;
  using Out = RotOut;
  float eps;

  struct Cluster {
    float wsum[4] = {0.f, 0.f, 0.f, 0.f};
    float cs = 0.f, sn = 0.f, ssum = 0.f;
    Gauss g = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

    // the fused box (wbf.py's fuse) and its Gaussian terms
    __device__ void refresh() {
      const float den = max_lo(ssum, 1e-12f);
      const float angle =
          __fmul_rn(0.5f, atan2f(sn, ssum > 0.f ? cs : 1.f));
      g = gauss_of(__fdiv_rn(wsum[0], den), __fdiv_rn(wsum[1], den),
                   __fdiv_rn(wsum[2], den), __fdiv_rn(wsum[3], den), angle);
    }
    __device__ void open(float s, const Cand& c) {
      for (int i = 0; i < 4; ++i) wsum[i] = __fmul_rn(s, c.box[i]);
      cs = __fmul_rn(s, c.c2);
      sn = __fmul_rn(s, c.s2);
      ssum = s;
      refresh();
    }
    __device__ void merge(float s, const Cand& c) {
      for (int i = 0; i < 4; ++i)
        wsum[i] = __fadd_rn(wsum[i], __fmul_rn(s, c.box[i]));
      cs = __fadd_rn(cs, __fmul_rn(s, c.c2));
      sn = __fadd_rn(sn, __fmul_rn(s, c.s2));
      ssum = __fadd_rn(ssum, s);
      refresh();
    }
    __device__ float overlap(const Cand& c, float eps) const {
      return clamp0(probiou(c.g, g, eps));
    }
    __device__ void store(const Out& o, size_t at) const {
      for (int i = 0; i < 4; ++i) o.wsum[at * 4 + i] = wsum[i];
      o.cs[at] = cs;
      o.sn[at] = sn;
      o.ssum[at] = ssum;
    }
  };

  __device__ float overlap(const Cluster& cl, const Cand& c) const {
    return cl.overlap(c, eps);
  }

  __device__ static Cand load(const float* g) {
    Cand c;
    for (int i = 0; i < 4; ++i) c.box[i] = __ldg(g + i);
    const float angle = __ldg(g + 4);
    const float twice = __fmul_rn(2.f, angle);
    c.c2 = cosf(twice);
    c.s2 = sinf(twice);
    c.g = gauss_of(c.box[0], c.box[1], c.box[2], c.box[3], angle);
    return c;
  }
};

template <class P>
__global__ void __launch_bounds__(kMaxClusters)
wbf_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           const int* __restrict__ labels, const int* __restrict__ order,
           int K, float thr, float gate, int class_aware, int D,
           const P policy, const typename P::Out out) {
  __shared__ unsigned red_key[2][32];
  __shared__ unsigned red_k[2][32];

  const int b = blockIdx.x;
  const int d = threadIdx.x;
  const int lane = d & 31;
  const int warp = d >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* g = boxes + static_cast<size_t>(b) * K * P::kDim;
  const float* s_in = scores + static_cast<size_t>(b) * K;
  const int* l_in = labels + static_cast<size_t>(b) * K;
  const int* o_in = order + static_cast<size_t>(b) * K;

  typename P::Cluster cl;                      // slot d's cluster
  int n = 0, top = 0, lab = -1;
  int n_open = 0;                              // the same in every thread
  for (int t = 0; t < K; ++t) {
    const float s = __ldg(s_in + t);
    if (!(s > gate)) break;                    // the rest is dead too
    const int label = __ldg(l_in + t);
    const typename P::Cand c = P::load(g + static_cast<size_t>(t) * P::kDim);
    // --- this slot's overlap, as an order key (0: not a candidate)
    unsigned key = 0u;
    if (d < n_open && (!class_aware || lab == label)) {
      const float iou = policy.overlap(cl, c);
      if (iou >= thr) key = order_key(iou);
    }
    // --- the block's argmax: largest overlap, lowest slot on ties
    unsigned k = d;
    warp_argmax(key, k);
    const int par = t & 1;
    if (lane == 0) {
      red_key[par][warp] = key;
      red_k[par][warp] = k;
    }
    __syncthreads();
    key = lane < nwarps ? red_key[par][lane] : 0u;
    k = lane < nwarps ? red_k[par][lane] : 0xffffffffu;
    warp_argmax(key, k);
    // --- merge into slot k, or open slot n_open
    if (key != 0u) {
      if (d == static_cast<int>(k)) {
        cl.merge(s, c);
        n += 1;
      }
    } else if (n_open < D) {
      if (d == n_open) {
        cl.open(s, c);
        n = 1;
        top = __ldg(o_in + t);
        lab = label;
      }
      ++n_open;
    }
  }
  if (d < D) {
    const size_t at = static_cast<size_t>(b) * D + d;
    cl.store(out, at);
    out.n[at] = n;
    out.top_i[at] = top;
    out.lab[at] = lab;
    out.active[at] = d < n_open;
  }
  if (d == 0) out.n_open[b] = n_open;
}

template <class P>
int launch_wbf(const void* boxes, const void* scores, const void* labels,
               const void* order, int B, int K, float thr, float gate,
               int class_aware, int D, const P& policy,
               const typename P::Out& out, void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || D <= 0 || D > kMaxClusters)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (D + 31) / 32 * 32;
  wbf_kernel<P><<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const int*>(labels), static_cast<const int*>(order), K, thr,
      gate, class_aware, D, policy, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K5. Launches B blocks of ceil(D / 32) warps on `stream`; D <= 1024.
// Returns a CUDA error code, 0 on success.
int xrseg_wbf(const void* boxes, const void* scores, const void* labels,
              const void* order, int B, int K, float thr, float gate,
              int class_aware, int D, void* wsum, void* ssum, void* n,
              void* top_i, void* lab, void* active, void* n_open,
              void* stream) {
  const AxisOut out{static_cast<float*>(wsum), static_cast<float*>(ssum),
                    static_cast<int*>(n),      static_cast<int*>(top_i),
                    static_cast<int*>(lab),    static_cast<bool*>(active),
                    static_cast<int*>(n_open)};
  return launch_wbf(boxes, scores, labels, order, B, K, thr, gate,
                    class_aware, D, Axis{}, out, stream);
}

// K6: the same over rotated boxes [B, K, 5], with probIoU's eps.
int xrseg_wbf_rotated(const void* boxes, const void* scores,
                      const void* labels, const void* order, int B, int K,
                      float thr, float gate, float eps, int class_aware, int D,
                      void* wsum, void* cs, void* sn, void* ssum, void* n,
                      void* top_i, void* lab, void* active, void* n_open,
                      void* stream) {
  const RotOut out{static_cast<float*>(wsum), static_cast<float*>(cs),
                   static_cast<float*>(sn),   static_cast<float*>(ssum),
                   static_cast<int*>(n),      static_cast<int*>(top_i),
                   static_cast<int*>(lab),    static_cast<bool*>(active),
                   static_cast<int*>(n_open)};
  return launch_wbf(boxes, scores, labels, order, B, K, thr, gate,
                    class_aware, D, Rot{eps}, out, stream);
}

}  // extern "C"
