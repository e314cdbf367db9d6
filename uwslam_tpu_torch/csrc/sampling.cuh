// Device routines shared by the sampling kernels (warp_sample.cu: K2 and K3;
// lm_evaluate.cu: the fused LM evaluation): the rigid warp and projection of
// a point, the taps of the CPU gather, and the bilinear blend of planar and
// texel images.
//
// Every multiply, add and divide here is an explicitly rounded intrinsic, in
// the order the plain PyTorch versions (uwslam_tpu_torch/ops/cuda_track.py
// and cuda_sample.py) evaluate them, so kernel and plain version agree bit
// for bit, validity masks at the exact image edges included.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace uws {

constexpr int kThreads = 256;

// Taps of the CPU gather (uwslam_tpu/image/pyramid.py:bilinear_sample) at
// (u, v): the top-left tap is clamped to column W-2 and row H-2 while the
// weights come from the unclamped floor, so a point at exactly u = W-1
// returns column W-2. Returns false for a point outside [0, W-1] x [0, H-1]
// (NaN included); *idx is then left unset.
__device__ __forceinline__ bool bilinear_taps(float u, float v, int H, int W,
                                              int* idx, float* du,
                                              float* dv) {
  const bool inside = (u >= 0.0f) && (u <= static_cast<float>(W - 1)) &&
                      (v >= 0.0f) && (v <= static_cast<float>(H - 1));
  if (!inside) return false;
  const float u0 = floorf(u);
  const float v0 = floorf(v);
  *du = __fsub_rn(u, u0);
  *dv = __fsub_rn(v, v0);
  const int u0i = min(max(static_cast<int>(u0), 0), W - 2);
  const int v0i = min(max(static_cast<int>(v0), 0), H - 2);
  *idx = v0i * W + u0i;
  return true;
}

// i00 (1-du)(1-dv) + i01 du (1-dv) + i10 (1-du) dv + i11 du dv, left to right.
__device__ __forceinline__ float blend(float i00, float i01, float i10,
                                       float i11, float du, float dv) {
  const float odu = __fsub_rn(1.0f, du);
  const float odv = __fsub_rn(1.0f, dv);
  float s = __fmul_rn(__fmul_rn(i00, odu), odv);
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(i01, du), odv));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(i10, odu), dv));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(i11, du), dv));
  return s;
}

// One channel of a planar image: four scalar loads.
__device__ __forceinline__ float bilinear_at(const float* __restrict__ ch,
                                             int idx, int W, float du,
                                             float dv) {
  return blend(__ldg(ch + idx), __ldg(ch + idx + 1), __ldg(ch + idx + W),
               __ldg(ch + idx + W + 1), du, dv);
}

// Three channels of a texel image {I, gx, gy, 0} (H, W, 4): four 128-bit
// loads, two per touched row, in place of twelve scalar loads on three
// planes.
__device__ __forceinline__ void bilinear_texel(const float4* __restrict__ tex,
                                               int idx, int W, float du,
                                               float dv, float* c0, float* c1,
                                               float* c2) {
  const float4 t00 = __ldg(tex + idx);
  const float4 t01 = __ldg(tex + idx + 1);
  const float4 t10 = __ldg(tex + idx + W);
  const float4 t11 = __ldg(tex + idx + W + 1);
  *c0 = blend(t00.x, t01.x, t10.x, t11.x, du, dv);
  *c1 = blend(t00.y, t01.y, t10.y, t11.y, du, dv);
  *c2 = blend(t00.z, t01.z, t10.z, t11.z, du, dv);
}

// ((r0 x + r1 y) + r2 z) + t
__device__ __forceinline__ float affine_row(const float* r, float x, float y,
                                            float z) {
  float s = __fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y));
  s = __fadd_rn(s, __fmul_rn(r[2], z));
  return __fadd_rn(s, r[3]);
}

struct Intrinsics {
  float fx, fy, cx, cy;
};

// A reference point (px, py, pz) warped by `pose` (rows 0..2 of the pair's
// 4x4 pose, 12 floats) and projected: p_t = R p + t,
// (u, v) = (fx x/zs + cx, fy y/zs + cy) with zs = z guarded at |z| < 1e-9.
struct Warped {
  float x, y, z, zs, u, v;
};

__device__ __forceinline__ Warped warp_project(const float* pose, float px,
                                               float py, float pz,
                                               Intrinsics k) {
  Warped w;
  w.x = affine_row(pose, px, py, pz);
  w.y = affine_row(pose + 4, px, py, pz);
  w.z = affine_row(pose + 8, px, py, pz);
  w.zs = fabsf(w.z) < 1e-9f ? 1e-9f : w.z;
  w.u = __fadd_rn(__fdiv_rn(__fmul_rn(k.fx, w.x), w.zs), k.cx);
  w.v = __fadd_rn(__fdiv_rn(__fmul_rn(k.fy, w.y), w.zs), k.cy);
  return w;
}

}  // namespace uws
