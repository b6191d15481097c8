// probIoU of rotated boxes on their Gaussian embeddings, shared by
// nms_rotated.cu (K3) and wbf.cu (K6).
//
// Every function keeps the operation order of the plain torch versions
// (ops/nms_kernels.probiou_gauss, ops/wbf._gauss) with round-to-nearest
// intrinsics for + - * / and sqrt, and logf/expf/cosf/sinf (what torch's
// CUDA ops call; never the __logf-style approximations). The files that
// include it are built with -fmad=false.
#pragma once

#include <cuda_runtime.h>

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

// The Gaussian terms of the rotated box (cx, cy, w, h, angle): each side
// floored at 1e-3 px, w^2/12 and h^2/12 rotated by the angle, and det =
// max(ab - c^2, 0); ops/wbf._gauss in torch.
__device__ __forceinline__ Gauss gauss_of(float cx, float cy, float w,
                                          float h, float angle) {
  w = w < 1e-3f ? 1e-3f : w;                       // clamp_min: NaN stays
  h = h < 1e-3f ? 1e-3f : h;
  const float a0 = __fdiv_rn(__fmul_rn(w, w), 12.f);
  const float b0 = __fdiv_rn(__fmul_rn(h, h), 12.f);
  const float cs = cosf(angle);
  const float sn = sinf(angle);
  const float a = __fadd_rn(__fmul_rn(__fmul_rn(a0, cs), cs),
                            __fmul_rn(__fmul_rn(b0, sn), sn));
  const float b = __fadd_rn(__fmul_rn(__fmul_rn(a0, sn), sn),
                            __fmul_rn(__fmul_rn(b0, cs), cs));
  const float c = __fmul_rn(__fmul_rn(__fsub_rn(a0, b0), cs), sn);
  return {cx, cy, a, b, c,
          clamp0(__fsub_rn(__fmul_rn(a, b), __fmul_rn(c, c)))};
}

}  // namespace
