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
// What bounds it on this card: bytes. The output is 4 * D * H * W bytes
// per image (41 MB at B = 8, D = 50, 160x160) and the prototypes 26 MB,
// against 2 * NM flops per output value that lies INSIDE its box. A value
// outside is 0 whatever the product, and most values are outside (a box
// covers a small part of the mask), so the work that is left is writing
// the output once and reading the prototypes once.
//
// What the design does about it:
// - A warp owns a tile of kTileW = 32 consecutive pixels of one mask row; a
//   lane owns one pixel and keeps its NM prototypes in registers. The tile
//   arrives by coalesced 16-byte loads and is transposed to one pixel a
//   lane through a staging buffer in shared memory that belongs to the
//   warp alone: no block barrier after the set-up.
// - Per instance the warp first tests its tile's extent against the box,
//   which is uniform over the warp. A tile with no pixel inside stores
//   zeros and does nothing else: no coefficient load, no product, no
//   exponential. Only a tile that meets the box reads the coefficients,
//   as 8 float4 broadcasts from shared memory that feed the 32 fused
//   multiply-adds, and only a pixel inside pays for the sigmoid.
// - Stores and prototype loads are streaming (st.global.cs, ld.global.cs):
//   each byte passes once. A warp's store covers 128 consecutive bytes of
//   one output row.
// - The grid is (tiles of an image / kWarps, B): blocks of kWarps
//   independent warps, many more than the card holds at once, so the
//   hardware's block scheduler evens out tiles that meet many boxes
//   against tiles that meet none. One row a tile keeps the registers low
//   (the most warps in flight) and the tile narrow (the fewest boxes met).
//
// Numerics: the dot product uses explicit fused multiply-adds in the order
// n = 0..NM-1 (the file is built with -fmad=false, which would otherwise
// split them); the sigmoid is 1 / (1 + expf(-x)), torch's formula. Values
// differ from the plain version's cuBLAS product by summation order only.
// Skipping a tile or a pixel changes no value: the skipped ones are
// exactly those the per-pixel test would zero (a NaN bound fails both
// tests' "outside" side, runs the per-pixel test, and stores 0).

#include <cuda_runtime.h>

namespace {

constexpr int kNm = 32;            // prototypes per pixel (ModelConfig.num_masks)
constexpr int kNm4 = kNm / 4;      // ... as float4
constexpr int kWarps = 4;          // warps per block, each on its own tile
constexpr int kTileW = 32;         // pixels of one mask row per warp
// staging row stride in float4: one float4 of padding keeps both the
// row-wise 16-byte stores and the lane-wise 16-byte loads conflict-free
constexpr int kStage4 = kNm4 + 1;
constexpr int kStageBytes = kWarps * kTileW * kStage4 * sizeof(float4);

__global__ void __launch_bounds__(kWarps * 32)
mask_synth_crop_kernel(const float* __restrict__ coefs,
                       const float* __restrict__ protos,
                       const float* __restrict__ boxes, int D, int H, int W,
                       float sx, float sy, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float4* sc4 = smem4;                         // [D, kNm4] coefficients
  float4* sb4 = sc4 + D * kNm4;                // [D] lo_x hi_x lo_y hi_y
  float4* stage_all = sb4 + D;                 // [kWarps, kTileW, kStage4]

  const int b = blockIdx.y;
  const int HW = H * W;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float4* cb4 =
      reinterpret_cast<const float4*>(coefs + static_cast<size_t>(b) * D * kNm);
  const float* bb = boxes + static_cast<size_t>(b) * D * 4;
  for (int i = threadIdx.x; i < D * kNm4; i += blockDim.x) sc4[i] = cb4[i];
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float cx = __fmul_rn(bb[4 * d], sx);
    const float cy = __fmul_rn(bb[4 * d + 1], sy);
    const float hw = __fmul_rn(__fmul_rn(bb[4 * d + 2], sx), 0.5f);
    const float hh = __fmul_rn(__fmul_rn(bb[4 * d + 3], sy), 0.5f);
    sb4[d] = make_float4(__fsub_rn(cx, hw), __fadd_rn(cx, hw),
                         __fsub_rn(cy, hh), __fadd_rn(cy, hh));
  }
  __syncthreads();                             // the block's only barrier

  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tile = blockIdx.x * kWarps + warp;
  if (tile >= tiles_x * H) return;             // no barrier follows
  const int x0 = (tile % tiles_x) * kTileW;
  const int y = tile / tiles_x;
  const int n_cols = min(kTileW, W - x0);      // columns of the tile in the mask

  // --- the tile's prototypes: coalesced loads, then one pixel a lane
  float4 v[kNm4];
  const float4* gp = reinterpret_cast<const float4*>(
      protos + (static_cast<size_t>(b) * HW + static_cast<size_t>(y) * W + x0) *
                   kNm);
#pragma unroll
  for (int it = 0; it < kNm4; ++it) {
    const int i = it * 32 + lane;              // float4 index in the tile
    v[it] = (i / kNm4 < n_cols) ? __ldcs(gp + i)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4* stage = stage_all + warp * kTileW * kStage4;
#pragma unroll
  for (int it = 0; it < kNm4; ++it) {
    const int i = it * 32 + lane;
    stage[(i / kNm4) * kStage4 + (i % kNm4)] = v[it];
  }
  __syncwarp();
#pragma unroll
  for (int n4 = 0; n4 < kNm4; ++n4) v[n4] = stage[lane * kStage4 + n4];

  // --- per instance: zeros, or the product where the tile meets the box
  const float tx0 = static_cast<float>(x0);
  const float tx1 = static_cast<float>(x0 + n_cols - 1);
  const float px = static_cast<float>(x0 + lane);
  const float py = static_cast<float>(y);
  float* ob = out + static_cast<size_t>(b) * D * HW +
              static_cast<size_t>(y) * W + x0 + lane;
  for (int d = 0; d < D; ++d) {
    const float4 bd = sb4[d];                  // lo_x hi_x lo_y hi_y
    float r = 0.f;
    const bool apart = bd.y < tx0 || bd.x > tx1 || bd.w < py || bd.z > py;
    if (!apart) {                              // uniform over the warp
      float acc = 0.f;
#pragma unroll
      for (int n4 = 0; n4 < kNm4; ++n4) {
        const float4 c = sc4[d * kNm4 + n4];
        acc = __fmaf_rn(c.x, v[n4].x, acc);
        acc = __fmaf_rn(c.y, v[n4].y, acc);
        acc = __fmaf_rn(c.z, v[n4].z, acc);
        acc = __fmaf_rn(c.w, v[n4].w, acc);
      }
      const bool inside = px >= bd.x && px <= bd.y && py >= bd.z &&
                          py <= bd.w;
      if (inside) r = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-acc)));
    }
    if (lane < n_cols) __stcs(ob + static_cast<size_t>(d) * HW, r);
  }
}

size_t shared_bytes(int D) {
  return static_cast<size_t>(D) * (kNm4 + 1) * sizeof(float4) + kStageBytes;
}

}  // namespace

extern "C" {

// Prototypes per pixel the kernel is built for.
int xrseg_mask_synth_crop_nm() { return kNm; }

// Largest D the kernel takes: the one whose coefficients and box bounds fit
// the block's shared memory next to the warps' staging buffers.
int xrseg_mask_synth_crop_max_d(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  const int fixed = kStageBytes + 1024;
  return optin > fixed
             ? (optin - fixed) / static_cast<int>((kNm4 + 1) * sizeof(float4))
             : 0;
}

// Launches grid (tiles of an image / kWarps, B) on `stream`; returns
// cudaGetLastError().
int xrseg_mask_synth_crop(const void* coefs, const void* protos,
                          const void* boxes, int B, int D, int H, int W,
                          float sx, float sy, void* out, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0) return 0;
  const size_t smem = shared_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(
      mask_synth_crop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = ((W + kTileW - 1) / kTileW) * H;
  const dim3 grid((tiles + kWarps - 1) / kWarps, B);
  mask_synth_crop_kernel<<<grid, kWarps * 32, smem,
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
