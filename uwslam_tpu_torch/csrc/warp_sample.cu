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
// Here each point is a 4-tap f32 gather with the CPU gather's semantics
// (sampling.cuh), bit-equal to the plain PyTorch versions.
//
// Bound on the card: bytes. A launch reads each point (12 B, or 8 B of uv),
// the sectors its taps touch, and a pose per pair, and writes 4 B per
// channel and 1 B of validity; the arithmetic is a few dozen operations per
// point. Two image layouts:
//   planar (B, C, H, W): four scalar loads per channel, so a point touches
//     two 32-byte sectors per plane;
//   texels (B, H, W, 4) = {I, gx, gy, 0}, the C = 3 case of the tracking
//     path: four 128-bit loads per point, two to four sectors in all.
// Grid: (point tile of 256, pair); one thread per point; the pose of the
// block's pair is read once into shared memory; uv is one 64-bit load.
#include "sampling.cuh"

using namespace uws;

namespace {

// Writes the samples of point n of pair b (0 where !ok) and its validity.
// TEXELS: img is (B, H, W, 4) and three channels are written; otherwise img
// is (B, C, H, W).
template <bool TEXELS>
__device__ __forceinline__ void sample_point(
    const float* __restrict__ img, float* __restrict__ out,
    uint8_t* __restrict__ valid, int b, int n, int C, int H, int W, int N,
    bool ok, int idx, float du, float dv) {
  const size_t plane = static_cast<size_t>(H) * W;
  float* o = out + static_cast<size_t>(b) * C * N + n;
  if constexpr (TEXELS) {
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    if (ok) {
      const float4* tex = reinterpret_cast<const float4*>(img) + b * plane;
      bilinear_texel(tex, idx, W, du, dv, &c0, &c1, &c2);
    }
    o[0] = c0;
    o[N] = c1;
    o[2 * static_cast<size_t>(N)] = c2;
  } else {
    const float* frame = img + static_cast<size_t>(b) * C * plane;
    for (int c = 0; c < C; ++c) {
      o[static_cast<size_t>(c) * N] =
          ok ? bilinear_at(frame + c * plane, idx, W, du, dv) : 0.0f;
    }
  }
  valid[static_cast<size_t>(b) * N + n] = ok ? 1 : 0;
}

template <bool TEXELS>
__global__ void warp_sample_kernel(const float* __restrict__ img,
                                   const float* __restrict__ p3d,
                                   const float* __restrict__ T,
                                   float* __restrict__ out,
                                   uint8_t* __restrict__ valid, int C, int H,
                                   int W, int N, Intrinsics k) {
  __shared__ float pose[12];  // rows 0..2 of the pair's 4x4 pose
  const int b = blockIdx.y;
  if (threadIdx.x < 12) pose[threadIdx.x] = T[static_cast<size_t>(b) * 16 + threadIdx.x];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* p = p3d + (static_cast<size_t>(b) * N + n) * 3;
  const Warped w = warp_project(pose, __ldg(p), __ldg(p + 1), __ldg(p + 2), k);
  int idx = 0;
  float du = 0.0f, dv = 0.0f;
  const bool ok = bilinear_taps(w.u, w.v, H, W, &idx, &du, &dv) && (w.z > 1e-3f);
  sample_point<TEXELS>(img, out, valid, b, n, C, H, W, N, ok, idx, du, dv);
}

template <bool TEXELS>
__global__ void bilinear_sample_kernel(const float* __restrict__ img,
                                       const float2* __restrict__ uv,
                                       float* __restrict__ out,
                                       uint8_t* __restrict__ valid, int C,
                                       int H, int W, int N) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float2 q = __ldg(uv + static_cast<size_t>(b) * N + n);
  int idx = 0;
  float du = 0.0f, dv = 0.0f;
  const bool ok = bilinear_taps(q.x, q.y, H, W, &idx, &du, &dv);
  sample_point<TEXELS>(img, out, valid, b, n, C, H, W, N, ok, idx, du, dv);
}

}  // namespace

// img: planar (B, C, H, W), or with texels != 0 (B, H, W, 4) and C == 3.
extern "C" int uws_warp_sample(const float* img, const float* p3d,
                               const float* T, float* out, uint8_t* valid,
                               int B, int C, int H, int W, int N, float fx,
                               float fy, float cx, float cy, int texels,
                               void* stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  const Intrinsics k{fx, fy, cx, cy};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (texels) {
    warp_sample_kernel<true><<<grid, kThreads, 0, s>>>(img, p3d, T, out, valid,
                                                       C, H, W, N, k);
  } else {
    warp_sample_kernel<false><<<grid, kThreads, 0, s>>>(img, p3d, T, out,
                                                        valid, C, H, W, N, k);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int uws_bilinear_sample(const float* img, const float* uv,
                                   float* out, uint8_t* valid, int B, int C,
                                   int H, int W, int N, int texels,
                                   void* stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  const float2* q = reinterpret_cast<const float2*>(uv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (texels) {
    bilinear_sample_kernel<true><<<grid, kThreads, 0, s>>>(img, q, out, valid,
                                                           C, H, W, N);
  } else {
    bilinear_sample_kernel<false><<<grid, kThreads, 0, s>>>(img, q, out, valid,
                                                            C, H, W, N);
  }
  return static_cast<int>(cudaGetLastError());
}
