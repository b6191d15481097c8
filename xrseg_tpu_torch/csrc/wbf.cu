// Greedy weighted box fusion (WBF) over a score-sorted candidate stream on
// Hopper (sm_90a): K5 (axis-aligned boxes, IoU) and K6 (rotated boxes,
// probIoU, doubled-angle circular mean).
//
// These are the port's own kernels. The JAX package has no Pallas kernel
// for WBF: it runs the merge as a lax.scan with one sequential step per
// candidate (xrseg_tpu/ops/wbf.py:90-136, rotated :188-227). In eager torch
// each step would be some 40 launches, so the scan runs here in four
// launches a call, with no host read. For each image, over the candidates
// t = 0, 1, ... sorted by score, descending, the scan computes:
//
//   alive  = s_t > gate; the stream is sorted, so the alive candidates are
//            a prefix and the scan ends at the first dead one (a dead step
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
// plain torch outside the kernels (ops/wbf.py), as in JAX.
//
// What bounds it on this card: a dependent chain. Each step is an overlap
// row, an argmax and a merge that the next step reads, so the time is the
// longest chain times one step's latency. The bytes (a few MB) and the
// operations (some 30 per open cluster per step) are far below the card's
// rates, and so far below the chain that the roofline bound says nothing.
//
// What the design does about it: it shortens the chain and each step.
//
// 1. Independent chains, exactly. Under class_aware a candidate can merge
//    only into a cluster of its own label, so the labels' sub-chains meet
//    only through the cap of D open clusters. A candidate goes to chain
//    g = label mod G (G = 1 without class_aware); labels that share a chain
//    stay apart by the label test inside the overlap. Each chain runs the
//    plain step over its own members in stream order:
//    - pass A: a chain opens while it holds fewer than D of its own
//      clusters, and records each open's stream position t (one bit of a
//      per-image bitmap);
//    - the cap: T_cap is the position of the D-th open of the image, over
//      all chains (none: no cap). Before T_cap nothing was dropped, so
//      every chain's pass-A clusters up to T_cap are the global scan's;
//      after it the global scan opens nothing;
//    - pass B: a chain that opened after T_cap in pass A runs again from
//      its start, opening only at t <= T_cap; the others keep pass A's
//      result, which then already equals the global scan's;
//    - slots: a kept cluster's slot is the rank of its open position among
//      the image's kept opens (the bitmap's popcount below it). Slot order
//      follows open order, so the lowest local index on ties is the
//      lowest slot.
//    The longest chain, not the live prefix, is now the serial length: the
//    largest label's members (all of them on a one-label stream).
// 2. Records off the chain. A parallel pre-pass computes each live
//    candidate's terms once with the policies' own load() (K5: corners and
//    area; K6: cos 2a, sin 2a and the Gaussian terms, four full-precision
//    trig calls) and writes them as 48- or 64-byte records.
// 3. No global load on a step. A chain walks the record stream in chunks of
//    32, staged in shared memory by cp.async kStages chunks ahead; a
//    ballot over the chunk's labels gives its members in order.
// 4. No barrier on a step for small D: a chain is one warp, its clusters
//    in the lanes' registers, the argmax two redux.sync (warp_argmax), and
//    four chains share a block, so one image's chains spread over many SMs.
//    K5 holds up to two clusters a lane (D <= 64); K6 one (D <= 32): two
//    probIoUs in a lane run one after the other (each division and square
//    root is a branch region), and at D = 50 a step of K6 took 0.87 us as
//    one warp against 0.68 us as a block of two warps (chip_smoke.py phase
//    8, one-label stream of 21504, NVIDIA H100 80GB HBM3 at 700 W). Beyond
//    that a chain is a block of ceil(D / 32) warps, one cluster a thread,
//    with the double-buffered partials and one block barrier a step.
//    ops/wbf.launch_plan chooses G, the team and the shared-memory bytes;
//    the launcher only validates them.
// 5. K5's overlap returns a zero intersection as it is: +-0 / den is +-0,
//    but a zero dividend takes the IEEE division's slow path, and most
//    clusters miss the candidate (the same phase-8 stream at 8400: 0.65 ->
//    0.45 us a step).
//
// The four launches: prep (records, bitmap cleared), pass A (partial
// clusters into scratch), cap (T_cap, the bitmap's word ranks, n_open, the
// closed slots), finish (pass B where needed, each kept cluster to its
// slot).
//
// Exactness: the outputs must equal the plain torch scan
// (ops/wbf.wbf_scan_plain, wbf_rotated_scan_plain) bit for bit on the card.
// Every step a chain runs uses the same expressions on the same members in
// the same order as the plain scan. The file is built with -fmad=false, and
// the arithmetic keeps the plain version's operation order with _rn
// intrinsics and the full-precision libm functions (atan2f, cosf, sinf,
// logf, expf). The thresholds come in as the float32 values the plain
// version compares against.

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "nms_common.cuh"
#include "probiou.cuh"

namespace {

constexpr int kMaxClusters = kMaxThreads;      // D <= 1024
constexpr int kChunk = 32;                     // records one ballot covers
constexpr int kStages = 4;                     // chunks in flight a chain
constexpr int kWarpChains = 4;                 // warp chains a block
constexpr int kPrepThreads = 256;
constexpr int kCapThreads = 512;
constexpr int kNoCap = INT_MAX;

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
  static constexpr int kWarpPerLane = 2;       // warp chains up to D = 64
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
      const float den =
          max_lo(__fsub_rn(__fadd_rn(c.area, area), inter), 1e-12f);
      // +-0 / den is inter itself; the division's slow path, which a zero
      // dividend takes, is skipped (most clusters miss the candidate)
      return inter == 0.f && den > 0.f ? inter : __fdiv_rn(inter, den);
    }
    __device__ void store(const Out& o, size_t at) const {
      for (int i = 0; i < 4; ++i) o.wsum[at * 4 + i] = wsum[i];
      o.ssum[at] = ssum;
    }
  };

  __device__ float overlap(const Cluster& cl, const Cand& c) const {
    return cl.overlap(c);
  }

  // the sums of cluster `from` of `src` to cluster `at` of `dst`
  __device__ static void copy(const Out& dst, size_t at, const Out& src,
                              size_t from) {
    for (int i = 0; i < 4; ++i) dst.wsum[at * 4 + i] = src.wsum[from * 4 + i];
    dst.ssum[at] = src.ssum[from];
  }

  // `n` clusters' sums and ints, cut from scratch by take(bytes)
  template <class Take>
  static Out carve(Take& take, size_t n) {
    Out o{};
    o.wsum = static_cast<float*>(take(n * 4 * sizeof(float)));
    o.ssum = static_cast<float*>(take(n * sizeof(float)));
    o.n = static_cast<int*>(take(n * sizeof(int)));
    o.top_i = static_cast<int*>(take(n * sizeof(int)));
    o.lab = static_cast<int*>(take(n * sizeof(int)));
    return o;
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
  // one probIoU a lane: two serialise on their divisions' and square
  // roots' branches, and a block of two warps is the faster team at D = 50
  static constexpr int kWarpPerLane = 1;
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

  __device__ static void copy(const Out& dst, size_t at, const Out& src,
                              size_t from) {
    for (int i = 0; i < 4; ++i) dst.wsum[at * 4 + i] = src.wsum[from * 4 + i];
    dst.cs[at] = src.cs[from];
    dst.sn[at] = src.sn[from];
    dst.ssum[at] = src.ssum[from];
  }

  template <class Take>
  static Out carve(Take& take, size_t n) {
    Out o{};
    o.wsum = static_cast<float*>(take(n * 4 * sizeof(float)));
    o.cs = static_cast<float*>(take(n * sizeof(float)));
    o.sn = static_cast<float*>(take(n * sizeof(float)));
    o.ssum = static_cast<float*>(take(n * sizeof(float)));
    o.n = static_cast<int*>(take(n * sizeof(int)));
    o.top_i = static_cast<int*>(take(n * sizeof(int)));
    o.lab = static_cast<int*>(take(n * sizeof(int)));
    return o;
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

// ---- the candidate records and the scratch they live in -----------------

// One candidate as a chain reads it: its terms, score, label and anchor.
// 48 bytes for K5, 64 for K6: whole 16-byte pieces for cp.async.
template <class P>
struct alignas(16) Rec {
  typename P::Cand c;
  float s;
  int label;
  int order;
};

// The per-call scratch, cut from one buffer the wrapper allocates.
template <class P>
struct Scratch {
  Rec<P>* rec;            // [B, K]
  unsigned* bitmap;       // [B, W]: bit t set where a pass-A chain opened
  int* wrank;             // [B, W]: set bits in the words before
  int* tcap;              // [B]: the position of the D-th open, or kNoCap
  int* count;             // [B, G]: clusters a chain opened in pass A
  int* pos;               // [B, G, D]: their open positions
  typename P::Out part;   // [B, G, D]: their sums, n, top_i, lab
};

// Lays the scratch out from `base` and returns its bytes; with a null base
// the pointers are the byte offsets.
template <class P>
size_t layout(int B, int K, int D, int G, char* base, Scratch<P>* s) {
  size_t off = 0;
  auto take = [&](size_t bytes) -> void* {
    void* p = reinterpret_cast<void*>(reinterpret_cast<uintptr_t>(base) + off);
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  const size_t W = (static_cast<size_t>(K) + 31) / 32;
  const size_t chains = static_cast<size_t>(B) * G;
  Scratch<P> x;
  x.rec = static_cast<Rec<P>*>(take(static_cast<size_t>(B) * K *
                                    sizeof(Rec<P>)));
  x.bitmap = static_cast<unsigned*>(take(B * W * sizeof(unsigned)));
  x.wrank = static_cast<int*>(take(B * W * sizeof(int)));
  x.tcap = static_cast<int*>(take(B * sizeof(int)));
  x.count = static_cast<int*>(take(chains * sizeof(int)));
  x.pos = static_cast<int*>(take(chains * D * sizeof(int)));
  x.part = P::carve(take, chains * D);
  if (s) *s = x;
  return off;
}

// ---- launch 1: the records ----------------------------------------------

template <class P>
__global__ void __launch_bounds__(kPrepThreads)
wbf_prep_kernel(const float* __restrict__ boxes,
                const float* __restrict__ scores,
                const int* __restrict__ labels, const int* __restrict__ order,
                int K, float gate, int W, Rec<P>* __restrict__ rec,
                unsigned* __restrict__ bitmap) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < W) bitmap[static_cast<size_t>(b) * W + t] = 0u;
  if (t >= K) return;
  const size_t at = static_cast<size_t>(b) * K + t;
  Rec<P> r{};
  r.s = __ldg(scores + at);
  r.label = __ldg(labels + at);
  r.order = __ldg(order + at);
  if (r.s > gate) r.c = P::load(boxes + at * P::kDim);   // dead: never read
  rec[at] = r;
}

// ---- launches 2 and 4: the chains ---------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// slot of the open at stream position p: the image's opens before it
__device__ __forceinline__ int slot_of(int p, const unsigned* bits,
                                       const int* wrank) {
  const int w = p >> 5;
  return wrank[w] + __popc(bits[w] & ((1u << (p & 31)) - 1u));
}

// A chain run by a team: one warp (kBlock false; R clusters a lane) or one
// block (kBlock true; a cluster a thread). Cluster j (local, in open
// order) lives in thread j % size, register q = j / size.
template <class P, int R, bool kBlock>
struct Chain {
  typename P::Cluster cl[R];
  int n[R] = {}, top[R] = {}, lab[R] = {}, pos[R] = {};
  int count = 0;                               // opened; the same everywhere
  int tid, size, lane, warp, nwarps, par = 0;
  unsigned (*red_key)[32];
  unsigned (*red_k)[32];

  __device__ void sync() const {
    if (kBlock) __syncthreads(); else __syncwarp();
  }

  // The team's largest key and the lowest local index holding it.
  __device__ void argmax(unsigned& key, unsigned& k) {
    warp_argmax(key, k);
    if (!kBlock) return;
    if (lane == 0) {
      red_key[par][warp] = key;
      red_k[par][warp] = k;
    }
    __syncthreads();
    key = lane < nwarps ? red_key[par][lane] : 0u;
    k = lane < nwarps ? red_k[par][lane] : 0xffffffffu;
    warp_argmax(key, k);
    par ^= 1;                    // the partials alternate: one barrier a step
  }

  // The plain step on member r at stream position t.
  __device__ void step(const P& policy, const Rec<P>& r, int t, float thr,
                       int class_aware, bool may_open) {
    unsigned key = 0u, k = 0xffffffffu;        // 0: not a candidate
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int j = q * size + tid;
      if (j < count && (!class_aware || lab[q] == r.label)) {
        const float iou = policy.overlap(cl[q], r.c);
        if (iou >= thr) {
          const unsigned kq = order_key(iou);
          if (kq > key) {                      // ascending j: lowest on ties
            key = kq;
            k = j;
          }
        }
      }
    }
    argmax(key, k);
    if (key != 0u) {
      const int q = static_cast<int>(k) / size;
      if (tid == static_cast<int>(k) - q * size) {
#pragma unroll
        for (int qq = 0; qq < R; ++qq)
          if (qq == q) {
            cl[qq].merge(r.s, r.c);
            n[qq] += 1;
          }
      }
    } else if (may_open) {
      const int q = count / size;
      if (tid == count - q * size) {
#pragma unroll
        for (int qq = 0; qq < R; ++qq)
          if (qq == q) {
            cl[qq].open(r.s, r.c);
            n[qq] = 1;
            top[qq] = r.order;
            lab[qq] = r.label;
            pos[qq] = t;
          }
      }
      ++count;
    }
  }

  // Walk the image's records: every member of chain g up to the first dead
  // candidate, in stream order. Opens at t <= last_open while fewer than D.
  __device__ void walk(const P& policy, const Rec<P>* rb, Rec<P>* ring, int K,
                       float thr, float gate, int class_aware, int D, int G,
                       int g, int last_open) {
    constexpr int kPieces = static_cast<int>(sizeof(Rec<P>) / 16);
    auto issue = [&](int c) {
      const int first = c * kChunk;
      if (first < K) {
        const int pieces = min(kChunk, K - first) * kPieces;
        const char* src = reinterpret_cast<const char*>(rb + first);
        char* dst = reinterpret_cast<char*>(ring + (c % kStages) * kChunk);
        for (int p = tid; p < pieces; p += size)
          cp_async16(dst + p * 16, src + p * 16);
      }
      cp_async_commit();                       // empty groups keep the count
    };
    for (int c = 0; c < kStages - 1; ++c) issue(c);
    for (int c = 0;; ++c) {
      issue(c + kStages - 1);
      cp_async_wait<kStages - 1>();            // chunk c's own pieces landed
      sync();                                  // and every thread's
      const Rec<P>* chunk = ring + (c % kStages) * kChunk;
      const int t0 = c * kChunk;
      bool dead = true, mine = false;
      if (t0 + lane < K) {
        const Rec<P>& x = chunk[lane];
        dead = !(x.s > gate);
        const int m = class_aware ? ((x.label % G) + G) % G : 0;
        mine = !dead && m == g;
      }
      const unsigned dm = __ballot_sync(kFull, dead);
      unsigned mm = __ballot_sync(kFull, mine);
      if (dm) mm &= (1u << (__ffs(dm) - 1)) - 1u;   // before the first dead
      while (mm) {
        const int j = __ffs(mm) - 1;
        mm &= mm - 1u;
        const int t = t0 + j;
        step(policy, chunk[j], t, thr, class_aware,
             t <= last_open && count < D);
      }
      sync();                        // the slot is refilled two lines down
      if (dm) break;
    }
    cp_async_wait<0>();
  }
};

// pass 0 (A): every chain runs, opening while it holds fewer than D, and
// writes its clusters and their open positions to scratch.
// pass 1 (finish): a chain that opened after T_cap runs again, opening only
// at t <= T_cap; every chain's kept clusters go to their slots.
template <class P, int R, bool kBlock>
__global__ void __launch_bounds__(kBlock ? kMaxThreads : 32 * kWarpChains)
wbf_chain_kernel(const Rec<P>* __restrict__ rec, int K, float thr,
                 float gate, int class_aware, int D, int G, int W, int pass,
                 const P policy, const Scratch<P> sc,
                 const typename P::Out out) {
  extern __shared__ float4 smem[];
  __shared__ unsigned red_key[2][32];
  __shared__ unsigned red_k[2][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = kBlock ? blockIdx.x : blockIdx.x * kWarpChains + warp;
  const int b = blockIdx.y;
  if (g >= G) return;                          // the whole team
  const int tid = kBlock ? threadIdx.x : lane;
  const int size = kBlock ? blockDim.x : 32;
  const size_t chain = static_cast<size_t>(b) * G + g;
  unsigned* bits = sc.bitmap + static_cast<size_t>(b) * W;
  const int* wrank = sc.wrank + static_cast<size_t>(b) * W;

  int last_open = kNoCap;
  if (pass == 1) {
    last_open = sc.tcap[b];
    const int count = sc.count[chain];
    if (count == 0) return;
    if (sc.pos[chain * D + count - 1] <= last_open) {
      // pass A's clusters are the global scan's: to their slots
      for (int i = tid; i < count; i += size) {
        const size_t from = chain * D + i;
        const size_t at = static_cast<size_t>(b) * D +
                          slot_of(sc.pos[from], bits, wrank);
        P::copy(out, at, sc.part, from);
        out.n[at] = sc.part.n[from];
        out.top_i[at] = sc.part.top_i[from];
        out.lab[at] = sc.part.lab[from];
        out.active[at] = true;
      }
      return;
    }
  }

  Chain<P, R, kBlock> ch;
  ch.tid = tid;
  ch.size = size;
  ch.lane = lane;
  ch.warp = warp;
  ch.nwarps = blockDim.x >> 5;
  ch.red_key = red_key;
  ch.red_k = red_k;
  Rec<P>* ring = reinterpret_cast<Rec<P>*>(smem) +
                 (kBlock ? 0 : warp * kStages * kChunk);
  ch.walk(policy, sc.rec + static_cast<size_t>(b) * K, ring, K, thr, gate,
          class_aware, D, G, g, last_open);

#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int j = q * size + tid;
    if (j >= ch.count) continue;
    size_t at;
    const typename P::Out* o;
    if (pass == 0) {
      at = chain * D + j;
      o = &sc.part;
      sc.pos[at] = ch.pos[q];
      atomicOr(bits + (ch.pos[q] >> 5), 1u << (ch.pos[q] & 31));
    } else {
      at = static_cast<size_t>(b) * D + slot_of(ch.pos[q], bits, wrank);
      o = &out;
      out.active[at] = true;
    }
    ch.cl[q].store(*o, at);
    o->n[at] = ch.n[q];
    o->top_i[at] = ch.top[q];
    o->lab[at] = ch.lab[q];
  }
  if (pass == 0 && tid == 0) sc.count[chain] = ch.count;
}

// ---- launch 3: the cap ----------------------------------------------------

// One block an image: the bitmap's word ranks (an exclusive scan of the
// words' popcounts), T_cap (the D-th set bit), n_open, and the closed slots
// [n_open, D) as the plain scan leaves them.
template <class P>
__global__ void __launch_bounds__(kCapThreads)
wbf_cap_kernel(int D, int W, const Scratch<P> sc, const typename P::Out out) {
  __shared__ int warp_sum[kCapThreads / 32];
  __shared__ int found;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned* bits = sc.bitmap + static_cast<size_t>(b) * W;
  int* wrank = sc.wrank + static_cast<size_t>(b) * W;
  if (threadIdx.x == 0) found = kNoCap;
  int carry = 0;                               // the same in every thread
  for (int base = 0; base < W; base += blockDim.x) {
    const int w = base + threadIdx.x;
    const unsigned word = w < W ? bits[w] : 0u;
    const int c = __popc(word);
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int i = 0; i < nwarps; ++i) {
      const int v = warp_sum[i];
      before += i < warp ? v : 0;
      total += v;
    }
    const int excl = carry + before + incl - c;
    if (w < W) wrank[w] = excl;
    if (excl < D && D <= excl + c) {           // this word holds the D-th
      unsigned x = word;
      for (int i = excl + 1; i < D; ++i) x &= x - 1u;
      found = w * 32 + __ffs(x) - 1;
    }
    carry += total;
    __syncthreads();
  }
  const int n_open = min(carry, D);
  if (threadIdx.x == 0) {
    sc.tcap[b] = found;
    out.n_open[b] = n_open;
  }
  typename P::Cluster closed;                  // zero sums
  for (int d = n_open + threadIdx.x; d < D; d += blockDim.x) {
    const size_t at = static_cast<size_t>(b) * D + d;
    closed.store(out, at);
    out.n[at] = 0;
    out.top_i[at] = 0;
    out.lab[at] = -1;
    out.active[at] = false;
  }
}

template <class P, int R, bool kBlock>
int launch_chains(const Scratch<P>& sc, int B, int K, float thr, float gate,
                  int class_aware, int D, int G, int W, int threads, int smem,
                  const P& policy, const typename P::Out& out,
                  cudaStream_t stream) {
  const dim3 grid(kBlock ? G : (G + kWarpChains - 1) / kWarpChains, B);
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      wbf_cap_kernel<P><<<B, kCapThreads, 0, stream>>>(D, W, sc, out);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    wbf_chain_kernel<P, R, kBlock><<<grid, threads, smem, stream>>>(
        sc.rec, K, thr, gate, class_aware, D, G, W, pass, policy, sc, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Validates the launch plan (ops/wbf.launch_plan) and issues the four
// launches on `stream`.
template <class P>
int launch_wbf(const void* boxes, const void* scores, const void* labels,
               const void* order, int B, int K, float thr, float gate,
               int class_aware, int D, int G, int per_thread, int team_warps,
               int smem, void* scratch, long long scratch_bytes,
               const P& policy, const typename P::Out& out, void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || D <= 0 || D > kMaxClusters || G < 1 ||
      (!class_aware && G != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ring = kStages * kChunk * static_cast<int>(sizeof(Rec<P>));
  const bool warp_team = team_warps == 1;
  const bool valid =
      warp_team ? (per_thread >= 1 && per_thread <= P::kWarpPerLane &&
                   per_thread * 32 >= D && smem == kWarpChains * ring)
                : (per_thread == 1 && team_warps * 32 >= D &&
                   team_warps <= kMaxThreads / 32 && smem == ring);
  Scratch<P> sc;
  if (!valid || scratch == nullptr ||
      static_cast<long long>(layout<P>(B, K, D, G, nullptr, &sc)) >
          scratch_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  layout<P>(B, K, D, G, static_cast<char*>(scratch), &sc);
  const int W = (K + 31) / 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  const dim3 prep_grid((K + kPrepThreads - 1) / kPrepThreads, B);
  wbf_prep_kernel<P><<<prep_grid, kPrepThreads, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const int*>(labels), static_cast<const int*>(order), K,
      gate, W, sc.rec, sc.bitmap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (!warp_team)
    return launch_chains<P, 1, true>(sc, B, K, thr, gate, class_aware, D, G,
                                     W, team_warps * 32, smem, policy, out,
                                     s);
  const int threads = 32 * kWarpChains;
  if (per_thread == 1)
    return launch_chains<P, 1, false>(sc, B, K, thr, gate, class_aware, D, G,
                                      W, threads, smem, policy, out, s);
  return launch_chains<P, P::kWarpPerLane, false>(
      sc, B, K, thr, gate, class_aware, D, G, W, threads, smem, policy, out,
      s);
}

}  // namespace

extern "C" {

// The scratch bytes a call needs (K6: rotated != 0), into *bytes.
int xrseg_wbf_scratch_bytes(int rotated, int B, int K, int D, int G,
                            long long* bytes) {
  if (B < 0 || K < 0 || D < 0 || G < 0) {
    *bytes = 0;
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *bytes = static_cast<long long>(
      rotated ? layout<Rot>(B, K, D, G, nullptr, nullptr)
              : layout<Axis>(B, K, D, G, nullptr, nullptr));
  return 0;
}

// Where the cap's and the chains' results sit in the scratch, for a report
// of the split: the byte offsets of tcap [B], count [B, G] and pos
// [B, G, D] (int32 each) into offsets[0..2].
int xrseg_wbf_scratch_offsets(int rotated, int B, int K, int D, int G,
                              long long* offsets) {
  auto fill = [&](auto s) {
    layout(B, K, D, G, nullptr, &s);           // null base: the offsets
    offsets[0] = reinterpret_cast<long long>(s.tcap);
    offsets[1] = reinterpret_cast<long long>(s.count);
    offsets[2] = reinterpret_cast<long long>(s.pos);
  };
  if (rotated) fill(Scratch<Rot>{}); else fill(Scratch<Axis>{});
  return 0;
}

// K5. Returns a CUDA error code, 0 on success.
int xrseg_wbf(const void* boxes, const void* scores, const void* labels,
              const void* order, int B, int K, float thr, float gate,
              int class_aware, int D, int G, int per_thread, int team_warps,
              int smem, void* scratch, long long scratch_bytes, void* wsum,
              void* ssum, void* n, void* top_i, void* lab, void* active,
              void* n_open, void* stream) {
  const AxisOut out{static_cast<float*>(wsum), static_cast<float*>(ssum),
                    static_cast<int*>(n),      static_cast<int*>(top_i),
                    static_cast<int*>(lab),    static_cast<bool*>(active),
                    static_cast<int*>(n_open)};
  return launch_wbf(boxes, scores, labels, order, B, K, thr, gate,
                    class_aware, D, G, per_thread, team_warps, smem, scratch,
                    scratch_bytes, Axis{}, out, stream);
}

// K6: the same over rotated boxes [B, K, 5], with probIoU's eps.
int xrseg_wbf_rotated(const void* boxes, const void* scores,
                      const void* labels, const void* order, int B, int K,
                      float thr, float gate, float eps, int class_aware, int D,
                      int G, int per_thread, int team_warps, int smem,
                      void* scratch, long long scratch_bytes, void* wsum,
                      void* cs, void* sn, void* ssum, void* n, void* top_i,
                      void* lab, void* active, void* n_open, void* stream) {
  const RotOut out{static_cast<float*>(wsum), static_cast<float*>(cs),
                   static_cast<float*>(sn),   static_cast<float*>(ssum),
                   static_cast<int*>(n),      static_cast<int*>(top_i),
                   static_cast<int*>(lab),    static_cast<bool*>(active),
                   static_cast<int*>(n_open)};
  return launch_wbf(boxes, scores, labels, order, B, K, thr, gate,
                    class_aware, D, G, per_thread, team_warps, smem, scratch,
                    scratch_bytes, Rot{eps}, out, stream);
}

}  // extern "C"
