// K1: Scharr gradients of a batch of frames, one launch per pyramid level.
//
// Replaces the TPU kernel uwslam_tpu/ops/pallas_pyramid.py:_scharr_kernel
// (launched by scharr_gradients_batched). Per frame, with edge-replicated
// 3x3 taps a b c / d . f / g h i:
//   gx = (3(c-a) + 10(f-d) + 3(i-g)) / 32
//   gy = (3(g-a) + 10(h-b) + 3(i-c)) / 32
//   gm = 0.5|gx| + 0.5|gy|
//
// Bound on the card: HBM bytes. Each pixel is read once from HBM (its eight
// neighbour taps hit L1/L2) and three f32 outputs are written: 16 B/pixel,
// 472 MB at level 0 of a 96 x 480 x 640 batch. One thread per output pixel,
// a 32 x 8 block per (column tile, row tile, frame), so a warp reads and
// writes 32 neighbouring floats of one row.
//
// Every add and multiply is an explicitly rounded intrinsic: nvcc may not
// contract them into FMAs, so the result is bit-identical to the plain
// PyTorch version (uwslam_tpu_torch/ops/cuda_pyramid.py), whose exact
// gradient magnitudes decide which pixels the point selection picks.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float tap(const float* __restrict__ f, int H, int W,
                                     int y, int x) {
  y = min(max(y, 0), H - 1);
  x = min(max(x, 0), W - 1);
  return __ldg(f + static_cast<size_t>(y) * W + x);
}

// 3(p - q) + 10(r - s) + 3(t - w), summed left to right, then / 32.
__device__ __forceinline__ float scharr(float p, float q, float r, float s,
                                        float t, float w) {
  float acc = __fmul_rn(3.0f, __fsub_rn(p, q));
  acc = __fadd_rn(acc, __fmul_rn(10.0f, __fsub_rn(r, s)));
  acc = __fadd_rn(acc, __fmul_rn(3.0f, __fsub_rn(t, w)));
  return __fmul_rn(acc, 0.03125f);
}

__global__ void scharr_kernel(const float* __restrict__ img,
                              float* __restrict__ gx, float* __restrict__ gy,
                              float* __restrict__ gm, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t frame = static_cast<size_t>(blockIdx.z) * H * W;
  const float* f = img + frame;
  const float a = tap(f, H, W, y - 1, x - 1);
  const float b = tap(f, H, W, y - 1, x);
  const float c = tap(f, H, W, y - 1, x + 1);
  const float d = tap(f, H, W, y, x - 1);
  const float e = tap(f, H, W, y, x + 1);
  const float g = tap(f, H, W, y + 1, x - 1);
  const float h = tap(f, H, W, y + 1, x);
  const float i = tap(f, H, W, y + 1, x + 1);
  const float vx = scharr(c, a, e, d, i, g);
  const float vy = scharr(g, a, h, b, i, c);
  const size_t o = frame + static_cast<size_t>(y) * W + x;
  gx[o] = vx;
  gy[o] = vy;
  gm[o] = __fadd_rn(__fmul_rn(0.5f, fabsf(vx)), __fmul_rn(0.5f, fabsf(vy)));
}

}  // namespace

extern "C" int uws_scharr(const float* img, float* gx, float* gy, float* gm,
                          int B, int H, int W, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8, B);
  scharr_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, gx, gy, gm, H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* uws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
