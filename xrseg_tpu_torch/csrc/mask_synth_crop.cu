// Fused mask synthesis + box crop for Hopper (sm_90a).
//
// Replaces the TPU kernel xrseg_tpu/ops/pallas_kernels.py
// mask_synth_crop_pallas (K4; body _mask_kernel). For each image b,
// instance d and mask pixel p = (py, px):
//
//   out[b, d, p] = sigmoid(sum_n coefs[b, d, n] * protos[b, p, n])
//                  if the pixel lies inside box d (inclusive bounds in mask
//                  space: lo_x <= px <= hi_x, lo_y <= py <= hi_y), else 0
//
// with cx = box_x * sx, hw = box_w * sx * 0.5, lo_x = cx - hw,
// hi_x = cx + hw (and the same in y), sx = mask_w / input_w rounded to
// float32 once on the host: ops/masks.crop_masks' arithmetic, so the
// in/out decision equals the plain version's exactly. A leading batch
// stands for the JAX vmap and runs in the same launch.
//
// Inputs: coefs [B, D, NM] f32, protos [B, H*W, NM] f32 (the [h, w, nm]
// layout, pixel-major), boxes [B, D, 4] f32 (cx, cy, w, h in input
// pixels). Output: [B, D, H*W] f32.
//
// What bounds it on this card: the output, 4 * D * H * W bytes per image
// (41 MB at B = 8, D = 50, 160x160), against 2 * NM flops per output
// value; at NM = 32 that is 16 flops per byte written, under the card's
// float32 ratio (67 TFLOP/s over 3.35 TB/s = 20), so it is bound by writing
// the output, with the float32 FMA rate close behind.
//
// What the design does about it: one block per tile of 128 pixels of one
// image (grid = pixel tiles x B). The block stages the tile's prototype
// rows through shared memory with coalesced loads, then each thread keeps
// its pixel's NM values in registers; the image's coefficients and box
// bounds sit in shared memory and are read as broadcasts. Each thread loops
// over the D instances, and every store of the loop is coalesced along the
// pixels. Nothing is read twice from device memory and nothing but the
// output is written.
//
// Numerics: the dot product uses explicit fused multiply-adds (the file is
// built with -fmad=false, which would otherwise split them); the sigmoid is
// 1 / (1 + expf(-x)), torch's formula. Values differ from the plain
// version's cuBLAS product by summation order only.

#include <cuda_runtime.h>

namespace {

constexpr int kNm = 32;            // prototypes per pixel (ModelConfig.num_masks)
constexpr int kTile = 128;         // pixels per block, one per thread

__global__ void __launch_bounds__(kTile)
mask_synth_crop_kernel(const float* __restrict__ coefs,
                       const float* __restrict__ protos,
                       const float* __restrict__ boxes, int D, int H, int W,
                       float sx, float sy, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* sc = smem;                            // [D, kNm] coefficients
  float* sb = sc + D * kNm;                    // [D, 4] lo_x hi_x lo_y hi_y
  __shared__ float tile[kTile][kNm + 1];       // +1: no bank conflicts

  const int b = blockIdx.y;
  const int HW = H * W;
  const int p0 = blockIdx.x * kTile;
  const float* cb = coefs + static_cast<size_t>(b) * D * kNm;
  const float* bb = boxes + static_cast<size_t>(b) * D * 4;
  const float* pb = protos + (static_cast<size_t>(b) * HW + p0) * kNm;
  for (int i = threadIdx.x; i < D * kNm; i += blockDim.x) sc[i] = cb[i];
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float cx = __fmul_rn(bb[4 * d], sx);
    const float cy = __fmul_rn(bb[4 * d + 1], sy);
    const float hw = __fmul_rn(__fmul_rn(bb[4 * d + 2], sx), 0.5f);
    const float hh = __fmul_rn(__fmul_rn(bb[4 * d + 3], sy), 0.5f);
    sb[4 * d] = __fsub_rn(cx, hw);
    sb[4 * d + 1] = __fadd_rn(cx, hw);
    sb[4 * d + 2] = __fsub_rn(cy, hh);
    sb[4 * d + 3] = __fadd_rn(cy, hh);
  }
  const int n_pix = min(kTile, HW - p0);
  for (int i = threadIdx.x; i < n_pix * kNm; i += blockDim.x)
    tile[i / kNm][i % kNm] = pb[i];
  __syncthreads();

  const int p = p0 + threadIdx.x;
  if (threadIdx.x >= n_pix) return;            // no barrier follows
  float v[kNm];
#pragma unroll
  for (int n = 0; n < kNm; ++n) v[n] = tile[threadIdx.x][n];
  const float px = static_cast<float>(p % W);
  const float py = static_cast<float>(p / W);
  float* ob = out + static_cast<size_t>(b) * D * HW + p;
  for (int d = 0; d < D; ++d) {
    const float* c = sc + d * kNm;
    float acc = 0.f;
#pragma unroll
    for (int n = 0; n < kNm; ++n) acc = __fmaf_rn(c[n], v[n], acc);
    const float* bd = sb + 4 * d;
    const bool inside = px >= bd[0] && px <= bd[1] && py >= bd[2] &&
                        py <= bd[3];
    ob[static_cast<size_t>(d) * HW] =
        inside ? __fdiv_rn(1.f, __fadd_rn(1.f, expf(-acc))) : 0.f;
  }
}

}  // namespace

extern "C" {

// Prototypes per pixel the kernel is built for.
int xrseg_mask_synth_crop_nm() { return kNm; }

// Largest D the kernel takes: the one whose coefficients and box bounds fit
// the block's shared memory next to the prototype tile.
int xrseg_mask_synth_crop_max_d(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  const int fixed = kTile * (kNm + 1) * sizeof(float) + 1024;
  return optin > fixed ? (optin - fixed) / ((kNm + 4) * sizeof(float)) : 0;
}

// Launches grid (pixel tiles, B) on `stream`; returns cudaGetLastError().
int xrseg_mask_synth_crop(const void* coefs, const void* protos,
                          const void* boxes, int B, int D, int H, int W,
                          float sx, float sy, void* out, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0) return 0;
  const size_t smem = static_cast<size_t>(D) * (kNm + 4) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      mask_synth_crop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((H * W + kTile - 1) / kTile, B);
  mask_synth_crop_kernel<<<grid, kTile, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coefs), static_cast<const float*>(protos),
      static_cast<const float*>(boxes), D, H, W, sx, sy,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* xrseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
