// K2 and K3: bilinear sampling of C channels at scattered points, for a
// batch of frame pairs.
//
// K2 (uws_warp_sample) replaces the TPU kernel
// uwslam_tpu/ops/pallas_track.py:_kernel (wrapper warp_and_sample): per
// point, p_t = R p + t, (u, v) = (fx x/z + cx, fy y/z + cy) with |z| < 1e-9
// guarded, then a bilinear sample of every channel; valid = z > 1e-3 and
// (u, v) inside [0, W-1] x [0, H-1]; samples are 0 where invalid.
// K3 (uws_bilinear_sample) replaces uwslam_tpu/ops/pallas_sample.py:
// _sample_kernel: the same sample at given (u, v); valid = inside the image.
//
// The TPU kernels sample through one-hot matmuls on the MXU (bf16 in K2).
// Here each point is four f32 loads per channel with the CPU gather's
// semantics (uwslam_tpu/image/pyramid.py:bilinear_sample): the top-left tap
// is clamped to column W-2 and row H-2 while the weights come from the
// unclamped floor, so a point at exactly u = W-1 returns column W-2.
//
// Bound on the card: scattered 4-tap loads. One level of a 640 x 480 f32
// frame is 1.2 MB, so the taps of a pair's 2048 points stay in L1/L2; the
// kernel reads 12 B of point and 64 B of pose per point, and writes 4 B per
// channel. Grid: (point tile of 256, pair); one thread per point; the pose
// of the block's pair is read once into shared memory.
//
// Every multiply, add and divide is an explicitly rounded intrinsic, in the
// order the plain PyTorch versions (uwslam_tpu_torch/ops/cuda_track.py and
// cuda_sample.py) evaluate them, so kernel and plain version agree bit for
// bit, validity masks at the exact image edges included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Taps of the CPU gather at (u, v). Returns false for a point outside
// [0, W-1] x [0, H-1] (NaN included); *idx is then left unset.
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
__device__ __forceinline__ float bilinear_at(const float* __restrict__ ch,
                                             int idx, int W, float du,
                                             float dv) {
  const float i00 = __ldg(ch + idx);
  const float i01 = __ldg(ch + idx + 1);
  const float i10 = __ldg(ch + idx + W);
  const float i11 = __ldg(ch + idx + W + 1);
  const float odu = __fsub_rn(1.0f, du);
  const float odv = __fsub_rn(1.0f, dv);
  float s = __fmul_rn(__fmul_rn(i00, odu), odv);
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(i01, du), odv));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(i10, odu), dv));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(i11, du), dv));
  return s;
}

// Writes all C samples of point n of pair b (0 where !ok) and its validity.
__device__ __forceinline__ void sample_point(
    const float* __restrict__ img, float* __restrict__ out,
    uint8_t* __restrict__ valid, int b, int n, int C, int H, int W, int N,
    bool ok, int idx, float du, float dv) {
  const size_t plane = static_cast<size_t>(H) * W;
  const float* frame = img + static_cast<size_t>(b) * C * plane;
  float* o = out + static_cast<size_t>(b) * C * N + n;
  for (int c = 0; c < C; ++c) {
    o[static_cast<size_t>(c) * N] =
        ok ? bilinear_at(frame + c * plane, idx, W, du, dv) : 0.0f;
  }
  valid[static_cast<size_t>(b) * N + n] = ok ? 1 : 0;
}

// ((r0 x + r1 y) + r2 z) + t
__device__ __forceinline__ float affine_row(const float* r, float x, float y,
                                            float z) {
  float s = __fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y));
  s = __fadd_rn(s, __fmul_rn(r[2], z));
  return __fadd_rn(s, r[3]);
}

__global__ void warp_sample_kernel(const float* __restrict__ img,
                                   const float* __restrict__ p3d,
                                   const float* __restrict__ T,
                                   float* __restrict__ out,
                                   uint8_t* __restrict__ valid, int C, int H,
                                   int W, int N, float fx, float fy, float cx,
                                   float cy) {
  __shared__ float pose[12];  // rows 0..2 of the pair's 4x4 pose
  const int b = blockIdx.y;
  if (threadIdx.x < 12) pose[threadIdx.x] = T[static_cast<size_t>(b) * 16 + threadIdx.x];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* p = p3d + (static_cast<size_t>(b) * N + n) * 3;
  const float px = p[0], py = p[1], pz = p[2];
  const float x = affine_row(pose, px, py, pz);
  const float y = affine_row(pose + 4, px, py, pz);
  const float z = affine_row(pose + 8, px, py, pz);
  const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
  const float u = __fadd_rn(__fdiv_rn(__fmul_rn(fx, x), zs), cx);
  const float v = __fadd_rn(__fdiv_rn(__fmul_rn(fy, y), zs), cy);
  int idx = 0;
  float du = 0.0f, dv = 0.0f;
  const bool ok = bilinear_taps(u, v, H, W, &idx, &du, &dv) && (z > 1e-3f);
  sample_point(img, out, valid, b, n, C, H, W, N, ok, idx, du, dv);
}

__global__ void bilinear_sample_kernel(const float* __restrict__ img,
                                       const float* __restrict__ uv,
                                       float* __restrict__ out,
                                       uint8_t* __restrict__ valid, int C,
                                       int H, int W, int N) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* q = uv + (static_cast<size_t>(b) * N + n) * 2;
  int idx = 0;
  float du = 0.0f, dv = 0.0f;
  const bool ok = bilinear_taps(q[0], q[1], H, W, &idx, &du, &dv);
  sample_point(img, out, valid, b, n, C, H, W, N, ok, idx, du, dv);
}

}  // namespace

extern "C" int uws_warp_sample(const float* img, const float* p3d,
                               const float* T, float* out, uint8_t* valid,
                               int B, int C, int H, int W, int N, float fx,
                               float fy, float cx, float cy, void* stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  warp_sample_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, p3d, T, out, valid, C, H, W, N, fx, fy, cx, cy);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int uws_bilinear_sample(const float* img, const float* uv,
                                   float* out, uint8_t* valid, int B, int C,
                                   int H, int W, int N, void* stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  bilinear_sample_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      img, uv, out, valid, C, H, W, N);
  return static_cast<int>(cudaGetLastError());
}
