// The greedy select-and-suppress NMS loop shared by nms_select.cu (K1, K2:
// axis-aligned IoU) and nms_rotated.cu (K3: probIoU), for Hopper (sm_90a).
//
// One image runs on one thread-block cluster of C blocks (C = 1, 2, 4 or 8).
// Block r of the cluster owns the contiguous candidates [r*S, r*S + S),
// S = ceil(K / C), and copies their scores and geometry into its own shared
// memory once; after that a greedy step touches no device memory. Within a
// block, thread t owns the candidates t, t + blockDim, ... of the slice and
// is the only thread that ever reads or writes them, so the resident rows
// need no barrier of their own.
//
// A step is one fused pass, one block barrier and one wait:
//   1. each thread, while it writes the suppressions of the box selected in
//      the step before over its candidates, keeps the best surviving (score,
//      index) among them: the argmax of the next step needs no second pass;
//   2. the warps reduce with redux.sync (two instructions: the largest
//      score key, then the lowest index that holds it), lane 0 of each warp
//      writes the warp's partial, one block barrier;
//   3. C = 1: every warp reduces the partials itself and reads the selected
//      box from the resident rows; the step is done.
//      C > 1: warp 0 reduces the partials, and its lanes 0..C-1 each send
//      the block's offer (score key, index and the candidate's geometry, 32
//      bytes) into slot [parity][rank] of one block of the cluster with two
//      st.async stores through distributed shared memory. Each store
//      signals the receiving block's mbarrier with its byte count, so a
//      block waits on its own shared memory for exactly the C offers of the
//      step, and nobody waits for a cluster-wide barrier. Every warp then
//      reduces the C offers and reads the winner's box from the slot of the
//      block that owns it.
// Slots, mbarriers and partials alternate by step parity. A block can send
// the offer of step t + 1 only after its own threads have all left step t
// (the block barrier of step t + 1 stands between), and it can receive an
// offer of step t + 2 only from a peer that holds its offer of step t + 1,
// so two sets are enough and no store ever lands in a slot still being read
// or in an mbarrier phase still open.
//
// Scores travel as order-preserving unsigned keys (order_key), so that the
// reductions are integer redux.sync. Ties go to the LOWEST index at every
// level (thread, warp, block, cluster): each level takes the largest key
// and then the lowest index among its holders, so the order in which
// partial results meet does not matter. An empty slice offers (0, K): key 0
// is below the key of every float, -inf included.
//
// A block leaves right after the last step's wait: by then every offer
// addressed to it has landed, and every peer stays until the offers this
// block sent have landed there.
//
// The kernel is one template over the cluster size and over a policy (the
// box type, how a slice's geometry is laid out in shared memory, and the
// overlap of two boxes). The launch plan (cluster size, threads,
// shared-memory bytes) is chosen in Python (ops/nms_kernels.launch_plan);
// launch() below only validates it.
#pragma once

#include <atomic>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr float kNeg = -FLT_MAX;               // float32 min
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;                 // the portable cluster size
constexpr int kStaticSmemReserve = 2048;       // partials, offers, mbarriers
constexpr unsigned kFull = 0xffffffffu;

// float -> unsigned, order-preserving for every non-NaN float; -0 and +0
// share a key, as they compare equal.
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(s + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The warp's largest key and the lowest index holding it, in every lane.
__device__ __forceinline__ void warp_argmax(unsigned& key, unsigned& k) {
  const unsigned best = __reduce_max_sync(kFull, key);
  k = __reduce_min_sync(kFull, key == best ? k : 0xffffffffu);
  key = best;
}

// --- distributed shared memory: addresses, mbarriers, st.async ------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of this block's shared address `local` in
// block `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ void mbar_init(uint32_t mbar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(mbar), "r"(arrivals) : "memory");
}

// One arrival that also announces `bytes` of st.async data for this phase.
__device__ __forceinline__ void mbar_expect(uint32_t mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(mbar), "r"(bytes) : "memory");
}

// Waits until the phase of parity `phase` has completed. A wait that would
// never end (an offer lost) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t mbar, unsigned phase) {
  for (unsigned tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n"
        " .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done) : "r"(mbar), "r"(phase) : "memory");
    if (done) return;
    if (tries > (1u << 22)) __trap();
  }
}

// 16 bytes into a peer's shared memory; the peer's mbarrier counts them.
__device__ __forceinline__ void send16(uint32_t remote, uint32_t remote_mbar,
                                       const uint4& q) {
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(remote), "r"(q.x), "r"(q.y), "r"(q.z), "r"(q.w),
         "r"(remote_mbar) : "memory");
}

// What one block offers the cluster in a step: the key of its best
// surviving score, that candidate's index in [0, K) and its geometry. 32
// bytes for both policies, sent as two 16-byte stores.
template <class Box>
struct alignas(16) Offer {
  unsigned key;
  unsigned k;
  Box box;
};

// A policy P provides:
//   P::Box                      one candidate's geometry
//   P::Selected                 the selected box as the overlap wants it,
//                               constructible from a Box
//   P::kFloats                  floats of geometry per candidate
//   P::from_global(g, K, k)     candidate k of the image whose geometry
//                               starts at g
//   P::put(rows, S, j, box), P::get(rows, S, j)
//                               slot j of the block's resident slice
//   p.overlap(selected, box)    the overlap the threshold is held against
template <class P, int C>
__global__ void __launch_bounds__(kMaxThreads)
greedy_nms_kernel(const float* __restrict__ geometry,
                  const float* __restrict__ scores, int K, float thr,
                  const P policy, int max_det, int* __restrict__ idx_out,
                  bool* __restrict__ ok_out) {
  using Box = typename P::Box;
  static_assert(sizeof(Offer<Box>) == 32, "an offer is two 16-byte stores");
  // the slice's geometry (16-byte aligned), then its masked scores
  extern __shared__ float4 smem[];
  __shared__ unsigned red_key[2][32];
  __shared__ unsigned red_k[2][32];
  __shared__ Offer<Box> offers[2][kMaxCluster];
  __shared__ alignas(8) unsigned long long mbar[2];

  const int rank = C == 1 ? 0 : static_cast<int>(
                                    cg::this_cluster().block_rank());
  const int b = blockIdx.x / C;
  const int S = (K + C - 1) / C;
  const int base = rank * S;
  const int n = min(S, K - base);              // <= 0: an empty slice
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;

  float* rows = reinterpret_cast<float*>(smem);
  float* sc = rows + static_cast<size_t>(P::kFloats) * S;
  const float* g = geometry + static_cast<size_t>(b) * P::kFloats * K;
  const float* s_in = scores + static_cast<size_t>(b) * K;
  int* idx = idx_out + static_cast<size_t>(b) * max_det;
  bool* okp = ok_out + static_cast<size_t>(b) * max_det;

  if (C > 1 && threadIdx.x == 0) {
    mbar_init(smem_addr(&mbar[0]), 1);
    mbar_init(smem_addr(&mbar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // the slice becomes resident; the thread's best for step 0 on the way
  // (ascending k within a thread, so '>' keeps the lowest index on ties)
  float v = -INFINITY;
  unsigned kk = K;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int k = base + j;
    const float s = s_in[k];
    sc[j] = s;
    P::put(rows, S, j, P::from_global(g, K, k));
    if (s > v) {
      v = s;
      kk = k;
    }
  }
  // every block of the cluster runs, with its mbarriers set up, before any
  // block sends to a peer
  if (C > 1) cg::this_cluster().sync();

  const unsigned ok_key = order_key(kNeg * 0.5f);
  for (int t = 0; t < max_det; ++t) {
    const int par = t & 1;
    // --- the block's best: warps, then the warps' partials
    unsigned key = kk < static_cast<unsigned>(K) ? order_key(v) : 0u;
    warp_argmax(key, kk);
    if (lane == 0) {
      red_key[par][warp] = key;
      red_k[par][warp] = kk;
    }
    __syncthreads();
    unsigned i;                                // the selected candidate
    Box box;
    if constexpr (C == 1) {
      key = lane < nwarps ? red_key[par][lane] : 0u;
      i = lane < nwarps ? red_k[par][lane] : K;
      warp_argmax(key, i);
      if (i < static_cast<unsigned>(K)) box = P::get(rows, S, i);
    } else {
      const uint32_t bar = smem_addr(&mbar[par]);
      if (warp == 0) {
        key = lane < nwarps ? red_key[par][lane] : 0u;
        kk = lane < nwarps ? red_k[par][lane] : K;
        warp_argmax(key, kk);
        // --- the block's offer, sent to every block of the cluster
        if (lane == 0) mbar_expect(bar, C * sizeof(Offer<Box>));
        if (lane < C) {
          Offer<Box> offer;
          offer.key = key;
          offer.k = kk;
          offer.box = kk < static_cast<unsigned>(K)
                          ? P::get(rows, S, kk - base) : Box{};
          uint4 q[2];
          memcpy(q, &offer, sizeof(offer));
          const uint32_t slot = peer_addr(smem_addr(&offers[par][rank]), lane);
          const uint32_t peer_bar = peer_addr(bar, lane);
          send16(slot, peer_bar, q[0]);
          send16(slot + 16, peer_bar, q[1]);
        }
      }
      // --- the cluster's best, with its box
      mbar_wait(bar, (t >> 1) & 1);
      key = lane < C ? offers[par][lane].key : 0u;
      i = lane < C ? offers[par][lane].k : K;
      warp_argmax(key, i);
      if (i < static_cast<unsigned>(K)) box = offers[par][i / S].box;
    }
    const bool ok = key > ok_key;
    if (rank == 0 && threadIdx.x == 0) {
      idx[t] = i;
      okp[t] = ok;
    }
    if (!ok) {
      // nothing is suppressed any more: every later step repeats this one
      if (rank == 0) {
        for (int u = t + 1 + threadIdx.x; u < max_det; u += blockDim.x) {
          idx[u] = i;
          okp[u] = false;
        }
      }
      return;                                  // uniform across the cluster
    }
    if (t + 1 == max_det) return;

    // --- the fused pass: suppress against box i, keep the best survivor.
    // A candidate already at NEG (suppressed, or below the gate) skips the
    // overlap: it could only be set to NEG again.
    const typename P::Selected selected(box);
    v = -INFINITY;
    kk = K;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const unsigned k = base + j;
      float s = sc[j];
      if (s != kNeg &&
          (k == i || policy.overlap(selected, P::get(rows, S, j)) > thr)) {
        s = kNeg;
        sc[j] = s;
      }
      if (s > v) {
        v = s;
        kk = k;
      }
    }
  }
}

// Shared-memory bytes of one block's resident slice.
template <class P>
constexpr long long slice_bytes(int K, int cluster) {
  return static_cast<long long>((K + cluster - 1) / cluster) *
         (P::kFloats + 1) * static_cast<long long>(sizeof(float));
}

// The launch of `clusters` clusters of C blocks; `attr` must outlive it.
template <int C>
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int clusters,
                                  int threads, int smem_bytes,
                                  cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(clusters) * C);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

// The (device, threads, bytes) of instance <P, C> that last had its
// shared-memory opt-in set and its placement checked; 0 for none.
template <class P, int C>
std::atomic<unsigned long long> g_placed{0};

// How many clusters of C blocks the current card runs at once when every
// block has an SM to itself (full blocks, each asking for more than half an
// SM's shared memory). The SMs of a cluster lie in one GPC, and the GPCs of
// a card need not hold a multiple of C usable SMs, so this can be less than
// SMs / C. Returns a CUDA error code.
template <class P, int C>
int cluster_room(int* clusters) {
  constexpr int kOverHalfAnSm = 116 * 1024;
  auto* kernel = greedy_nms_kernel<P, C>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kOverHalfAnSm);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      cluster_config<C>(&attr, 1024, kMaxThreads, kOverHalfAnSm, nullptr);
  g_placed<P, C>.store(0, std::memory_order_release);   // the opt-in moved
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, kernel, &config));
}

// What the launch plan is made from, for the current card: its SM count, a
// block's opt-in shared-memory limit in bytes, and room[0..3] = cluster_room
// for C = 1, 2, 4, 8. Returns a CUDA error code.
template <class P>
int card_limits(int* sm_count, int* smem_optin, int* room) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                               device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int err = cluster_room<P, 1>(room);
  if (err == 0) err = cluster_room<P, 2>(room + 1);
  if (err == 0) err = cluster_room<P, 4>(room + 2);
  if (err == 0) err = cluster_room<P, 8>(room + 3);
  return err;
}

template <class P, int C>
int launch_cluster(const float* geometry, const float* scores, int B, int K,
                   float thr, const P& policy, int max_det, int* idx, bool* ok,
                   int threads, int smem_bytes, cudaStream_t stream) {
  auto* kernel = greedy_nms_kernel<P, C>;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      cluster_config<C>(&attr, B, threads, smem_bytes, stream);

  // The shared-memory opt-in and the placement check are needed once per
  // (device, threads, bytes) of this instance; the last shape that passed
  // is remembered.
  std::atomic<unsigned long long>& placed = g_placed<P, C>;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long shape =
      (static_cast<unsigned long long>(device + 1) << 48) |
      (static_cast<unsigned long long>(threads) << 32) |
      static_cast<unsigned>(smem_bytes);
  if (placed.load(std::memory_order_acquire) != shape) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (e != cudaSuccess) return static_cast<int>(e);
    // the card cannot hold one cluster of this shape
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    placed.store(shape, std::memory_order_release);
  }
  e = cudaLaunchKernelEx(&config, kernel, geometry, scores, K, thr, policy,
                         max_det, idx, ok);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Validates the plan and launches B clusters of `cluster` blocks on
// `stream`. Returns a CUDA error code, 0 on success.
template <class P>
int launch(const void* geometry, const void* scores, int B, int K, float thr,
           const P& policy, int max_det, void* idx, void* ok, int cluster,
           int threads, int smem_bytes, void* stream) {
  if (B <= 0 || max_det <= 0) return 0;
  if (K <= 0 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      smem_bytes < slice_bytes<P>(K, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* g = static_cast<const float*>(geometry);
  const auto* s = static_cast<const float*>(scores);
  auto* i = static_cast<int*>(idx);
  auto* o = static_cast<bool*>(ok);
  auto st = static_cast<cudaStream_t>(stream);
  switch (cluster) {
    case 1:
      return launch_cluster<P, 1>(g, s, B, K, thr, policy, max_det, i, o,
                                  threads, smem_bytes, st);
    case 2:
      return launch_cluster<P, 2>(g, s, B, K, thr, policy, max_det, i, o,
                                  threads, smem_bytes, st);
    case 4:
      return launch_cluster<P, 4>(g, s, B, K, thr, policy, max_det, i, o,
                                  threads, smem_bytes, st);
    default:
      return launch_cluster<P, 8>(g, s, B, K, thr, policy, max_det, i, o,
                                  threads, smem_bytes, st);
  }
}

}  // namespace

extern "C" {

const char* xrseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
