// The conv epilogue for Hopper (sm_90a): bias, SiLU and the rounding to
// bf16 in one pass over each bf16 convolution's output.
//
// Replaces no Pallas kernel. The JAX package's conv_apply
// (xrseg_tpu/models/layers.py) writes the bias add, the SiLU and the cast
// as array code and leaves them to XLA, which fuses them into the
// convolution. Eager PyTorch runs the same composition
// (ops/conv_epilogue.conv_epilogue_torch) as four passes over the whole
// activation: .float(), + bias, silu, .to(bf16), 28 bytes an element with
// the SiLU and 20 without. This kernel is those four passes in one.
//
// For each element y[i] of channel c:
//
//   x      = float(y[i]) + bias[c]                  (float32 add, rounded)
//   x      = x / (1 + expf(-x))                     (act only: torch's silu
//                                                    formula, IEEE division,
//                                                    the accurate expf)
//   out[i] = bf16_rn(x)                             (round to nearest even)
//
// which is the composition's arithmetic step for step, so the result is
// bit-equal to it. The file is built with -fmad=false (_build.NVCC_FLAGS),
// so no multiply and add is contracted behind the source's back.
//
// Layouts: y [B, C, H, W] is dense in one of the two memory formats a cuDNN
// convolution writes, NCHW (channel = (i / (H*W)) % C) or channels-last
// (channel = i % C). `inner` is the distance in elements from one channel
// to the next: H*W for NCHW, 1 for channels-last. The output keeps y's
// layout. `out` may be `y` itself: each element is read and then written by
// the same thread, so the wrapper writes in place into the conv's fresh
// output (no pointer is __restrict__ for that reason).
//
// What bounds it on this card: bytes. Every element is read once (2 bytes)
// and written once (2 bytes), and the bias (C floats) stays in L1; about
// 20 flops an element of expf, division and rounding sit under the
// 3.35 TB/s line (~40 instructions an element at full bandwidth).
//
// What the design does about it:
// - A thread moves whole 16-byte vectors (8 bf16), two of them, both loads
//   issued before any arithmetic, so each thread keeps 32 bytes in flight.
// - NCHW with H*W % 8 == 0 (every plane of the YOLO11 stages: 320^2 to
//   20^2): the 8 lanes of a vector share one channel, found by one 32-bit
//   division a vector, and one bias load serves all 8.
//   Channels-last with C % 8 == 0: the vector holds channels c0..c0+7 of
//   one pixel, c0 from one 32-bit remainder a vector.
// - Where the plane or the channels come in fours only (YOLO12's ABlock
//   MLP, 460 channels, channels-last on the card), the same kernel on
//   8-byte vectors of 4 bf16, four of them a thread: still 32 bytes in
//   flight and one 32-bit division or remainder a vector.
// - Anything else (an odd plane or channel count, a start off the vector's
//   boundary) takes a scalar path, one element a thread.
// - One vector pair a thread and no grid-stride loop: a 20^2 plane of the
//   head at b=32 is still tens of thousands of threads, and the 320^2 stem
//   is millions, so every SM is full in both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 32;          // in flight, in either width

__device__ __forceinline__ float epilogue(float y, float b, bool act) {
  const float x = __fadd_rn(y, b);
  return act ? __fdiv_rn(x, __fadd_rn(1.0f, expf(-x))) : x;
}

// V is uint4 (8 bf16) or uint2 (4 bf16). kChannelsLast false: `div` is the
// vectors a plane (H*W / lanes); true: `div` is the vectors a pixel
// (C / lanes).
template <typename V, bool kAct, bool kChannelsLast>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_vec_kernel(const V* y, const float* bias, V* out,
                         uint32_t n_vec, uint32_t div, uint32_t C) {
  constexpr int kLanes = sizeof(V) / 2;
  constexpr int kVecPerThread = kBytesPerThread / sizeof(V);
  const uint32_t base =
      blockIdx.x * (kThreads * kVecPerThread) + threadIdx.x;
  V r[kVecPerThread];
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const uint32_t v = base + k * kThreads;
    if (v < n_vec) r[k] = y[v];
  }
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const uint32_t v = base + k * kThreads;
    if (v >= n_vec) continue;
    float b[kLanes];
    if (kChannelsLast) {
      const float* bc = bias + (v % div) * kLanes;
#pragma unroll
      for (int j = 0; j < kLanes; ++j) b[j] = __ldg(bc + j);
    } else {
      const float bc = __ldg(bias + (v / div) % C);
#pragma unroll
      for (int j = 0; j < kLanes; ++j) b[j] = bc;
    }
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r[k]);
#pragma unroll
    for (int j = 0; j < kLanes / 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(epilogue(f.x, b[2 * j], kAct),
                                   epilogue(f.y, b[2 * j + 1], kAct));
    }
    out[v] = r[k];
  }
}

template <bool kAct>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_scalar_kernel(const __nv_bfloat16* y, const float* bias,
                            __nv_bfloat16* out, long long n, long long inner,
                            int C) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const float b = __ldg(bias + (i / inner) % C);
    out[i] = __float2bfloat16_rn(epilogue(__bfloat162float(y[i]), b, kAct));
  }
}

// The vector kernel on vectors V (sizeof(V) / 2 bf16), or false where y,
// out, the plane and the channels do not allow them.
template <typename V, bool kAct>
bool launch_vec(const void* y, const float* bias, void* out, long long n,
                long long inner, int C, cudaStream_t stream) {
  constexpr int kLanes = sizeof(V) / 2;
  const bool aligned = (reinterpret_cast<uintptr_t>(y) % sizeof(V) == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % sizeof(V) == 0);
  const bool nchw = inner % kLanes == 0;
  const bool nhwc = inner == 1 && C % kLanes == 0;
  const long long n_vec = n / kLanes;
  if (!aligned || !(nchw || nhwc) || n_vec >= (1LL << 31)) return false;
  const int per_block = kThreads * (kBytesPerThread / sizeof(V));
  const unsigned grid =
      static_cast<unsigned>((n_vec + per_block - 1) / per_block);
  const V* yv = static_cast<const V*>(y);
  V* ov = static_cast<V*>(out);
  if (nchw)
    conv_epilogue_vec_kernel<V, kAct, false><<<grid, kThreads, 0, stream>>>(
        yv, bias, ov, static_cast<uint32_t>(n_vec),
        static_cast<uint32_t>(inner / kLanes), static_cast<uint32_t>(C));
  else
    conv_epilogue_vec_kernel<V, kAct, true><<<grid, kThreads, 0, stream>>>(
        yv, bias, ov, static_cast<uint32_t>(n_vec),
        static_cast<uint32_t>(C / kLanes), static_cast<uint32_t>(C));
  return true;
}

template <bool kAct>
cudaError_t launch(const void* y, const float* bias, void* out, long long n,
                   long long inner, int C, cudaStream_t stream) {
  if (!launch_vec<uint4, kAct>(y, bias, out, n, inner, C, stream) &&
      !launch_vec<uint2, kAct>(y, bias, out, n, inner, C, stream)) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    const unsigned grid =
        static_cast<unsigned>(blocks < 65536 ? blocks : 65536);
    conv_epilogue_scalar_kernel<kAct><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(y), bias,
        static_cast<__nv_bfloat16*>(out), n, inner, C);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[i] = bf16_rn([silu](float(y[i]) + bias[(i / inner) % C])) for the n
// elements of y, on `stream`, on card `device` (the current device is
// restored after the launch). `out` may equal `y`. Returns
// cudaGetLastError().
int xrseg_conv_epilogue(const void* y, const void* bias, void* out,
                        long long n, long long inner, int C, int act,
                        int device, void* stream) {
  if (n <= 0) return 0;
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = act ? launch<true>(y, b, out, n, inner, C, s)
          : launch<false>(y, b, out, n, inner, C, s);
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(e);
}

const char* xrseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
