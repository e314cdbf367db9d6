// lm_evaluate: one launch per Levenberg-Marquardt evaluation of a batch of
// frame pairs. It is K2 (uws_warp_sample, which replaces the TPU kernel
// uwslam_tpu/ops/pallas_track.py:_kernel) redesigned for this card: on the
// TPU the warp+sample kernel's (B, C, N) output is consumed by code that XLA
// fuses into a few kernels; eager PyTorch runs that code as 30 to 65 small
// launches per evaluation, each re-reading (B, N) or (B, N, 6) tensors.
//
// Per pair and point: warp by the pair's pose, project, sample the target
// (sampling.cuh: the CPU gather's edge semantics, valid = z > 1e-3 and
// inside, bit-equal to K2), residual r = I_tgt - I_ref, validity =
// point valid & sample valid, the Jacobian row J (6), the robust weight w
// and cost rho at the pair's scale sigma (clamped at 1; Huber k = 1.345, or
// no weighting). Then the pair's sums over its valid points leave the
// kernel, 48 floats per pair:
//   [0, 36)  H = sum w J J^T, the 21 upper entries summed and mirrored;
//   [36, 42) b = -sum w J r;
//   42       sum rho(r / sigma) sigma^2   (the robust cost times the count)
//   43       sum |r|                      (the basin guard's measure)
//   44       the valid count; [45, 48) zero.
// r, J and validity never reach device memory.
//
// Affine brightness (a second compile-time form): the pair's (a, b) come in
// like its pose, the residual is (r - a I_ref) - b, rounded as the plain
// version rounds it, and the Jacobian row gains the constant columns
// (-I_ref, -1), so 8 parameters: 36 upper entries of H (8 x 8), 8 of b, the
// cost, sum |r| of the affine residual and the count, 47 sums, 80 floats per
// pair: H in [0, 64), b in [64, 72), 72 the cost, 73 sum |r|, 74 the count,
// [75, 80) zero. Its 47 accumulators do not fit the 64 registers a thread
// has in a block of 1024, so this form is bounded at 256 threads.
//
// Two target forms. IC: the target is one plane (B, H, W) and J is the
// constant reference Jacobian (B, N, 6), read as three 64-bit loads. FC: the
// target is texels (B, H, W, 4) = {I, gx, gy, 0}, one 128-bit load per tap,
// and J is built from the sampled gradient, the pose's rotation and the
// point: g = (gx fx/z, gy fy/z, -(gx fx x + gy fy y)/z^2),
// J = [g R | (g R) x -hat(p)].
//
// Bound on the card: bytes (IC 57 B per point in, FC 33 B plus the texels'
// sectors; a few hundred operations per point), and at one pair the launch
// itself. A thread keeps its points' 30 (47) partial sums in registers; warp
// shuffles (a tree per sum; a butterfly over the sums has fewer shuffles but
// needs half as many registers again and was slower at 95 pairs), then
// shared memory, reduce a block. The blocks of a pair are one thread-block
// cluster of 1, 2, 4 or 8 blocks, chosen by the wrapper from the numbers of
// pairs and points (a thread strides over the points where a pair has more
// of them than its cluster has threads), and block 0 of the cluster reads
// the other blocks' partial sums through distributed shared memory: one
// pair of 2048 points spreads over 8 SMs and needs no second launch, while
// 95 pairs take 2 blocks each and reduce less often. Every sum is taken
// in a fixed order (no floating-point atomics): two launches on the same
// input give the same bits. The sample, the validity and the residual are
// bit-equal to the plain PyTorch version; J and the sums are plain C
// arithmetic, which the compiler contracts to fused multiply-adds, so they
// agree with the plain version to rounding.
#include <cooperative_groups.h>

#include "sampling.cuh"

namespace cg = cooperative_groups;
using namespace uws;

namespace {

constexpr int kMaxCluster = 8;
constexpr float kHuberK = 1.345f;
constexpr float kMinSigma = 1.0f;

enum Kind { kNone = 0, kHuber = 1 };

// The sums of one form: the pose alone (6 parameters) or the pose and the
// brightness (a, b) (8).
template <bool AFFINE>
struct Form {
  static constexpr int kN = AFFINE ? 8 : 6;          // parameters
  static constexpr int kUpper = kN * (kN + 1) / 2;   // H's upper entries
  static constexpr int kSums = kUpper + kN + 3;      // + b, cost, sum |r|, count
  static constexpr int kTail = kN * kN + kN;         // where cost, |r|, count go
  static constexpr int kOut = AFFINE ? 80 : 48;      // floats per pair
  static constexpr int kMaxThreads = AFFINE ? 256 : 1024;
  static constexpr int kMaxWarps = kMaxThreads / 32;
};

struct Args {
  const float* img;
  const float* p3d;
  const float* T;
  const float* ab;          // (B, 2) brightness, affine form only
  const float* ref_int;
  const uint8_t* pts_valid;
  const float* J_ref;       // IC only
  const float* sigma;
  float* out;
  int H, W, N, ref_stride;
  Intrinsics cam;
  int kind;
};

// Row and column of upper-triangle entry k of an n x n matrix, row-major.
template <int n>
__device__ __forceinline__ void upper_index(int k, int* row, int* col) {
  int i = 0;
  while (k >= n - i) {
    k -= n - i;
    ++i;
  }
  *row = i;
  *col = i + k;
}

// Adds one valid point's terms to the thread's partial sums.
template <int n>
__device__ __forceinline__ void accumulate(float* acc, const float* J, float r,
                                           float sigma, int kind) {
  constexpr int kUpper = n * (n + 1) / 2;
  float w = 1.0f;
  float rho = 0.5f * r * r;
  if (kind == kHuber) {
    const float x = __fdiv_rn(r, sigma);
    const float ax = fabsf(x);
    w = fminf(__fdiv_rn(kHuberK, fmaxf(ax, 1e-12f)), 1.0f);
    rho = ax <= kHuberK ? 0.5f * x * x : kHuberK * (ax - 0.5f * kHuberK);
    rho = rho * sigma * sigma;
  }
  float wJ[n];
#pragma unroll
  for (int i = 0; i < n; ++i) wJ[i] = w * J[i];
  int k = 0;
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = i; j < n; ++j) acc[k++] += J[i] * wJ[j];
  }
#pragma unroll
  for (int i = 0; i < n; ++i) acc[kUpper + i] += wJ[i] * r;
  acc[kUpper + n] += rho;
  acc[kUpper + n + 1] += fabsf(r);
  acc[kUpper + n + 2] += 1.0f;
}

template <bool FC, bool AFFINE>
__global__ void __launch_bounds__(Form<AFFINE>::kMaxThreads)
lm_evaluate_kernel(Args a) {
  using F = Form<AFFINE>;
  constexpr int n = F::kN;
  __shared__ float pose[14];               // rows 0..2 of the pair's pose, (a, b)
  __shared__ float warp_part[F::kMaxWarps][F::kSums];
  __shared__ float block_part[F::kSums];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  if (tid < 12) pose[tid] = a.T[static_cast<size_t>(b) * 16 + tid];
  if constexpr (AFFINE) {
    if (tid >= 12 && tid < 14) pose[tid] = a.ab[static_cast<size_t>(b) * 2 + tid - 12];
  }
  __syncthreads();
  const float sig = fmaxf(__ldg(a.sigma + b), kMinSigma);
  const size_t plane = static_cast<size_t>(a.H) * a.W;
  const int N = a.N;

  float acc[F::kSums];
#pragma unroll
  for (int i = 0; i < F::kSums; ++i) acc[i] = 0.0f;

  for (int i = blockIdx.x * blockDim.x + tid; i < N;
       i += gridDim.x * blockDim.x) {
    const size_t bn = static_cast<size_t>(b) * N + i;
    if (!a.pts_valid[bn]) continue;
    const float* p = a.p3d + bn * 3;
    const float px = __ldg(p), py = __ldg(p + 1), pz = __ldg(p + 2);
    const Warped w = warp_project(pose, px, py, pz, a.cam);
    int idx = 0;
    float du = 0.0f, dv = 0.0f;
    if (!(bilinear_taps(w.u, w.v, a.H, a.W, &idx, &du, &dv) && w.z > 1e-3f)) continue;
    float J[n];
    float i_t;
    if constexpr (FC) {
      float gx, gy;
      const float4* tex = reinterpret_cast<const float4*>(a.img) + b * plane;
      bilinear_texel(tex, idx, a.W, du, dv, &i_t, &gx, &gy);
      // dI/d(uv) . d(uv)/dp_t, then dp_t/d(delta) = [R | -R hat(p)] for the
      // right update T exp(delta).
      const float zi = __fdiv_rn(1.0f, w.zs);
      const float zi2 = zi * zi;
      const float g0 = gx * (a.cam.fx * zi);
      const float g1 = gy * (a.cam.fy * zi);
      const float g2 = gx * (-a.cam.fx * w.x * zi2) + gy * (-a.cam.fy * w.y * zi2);
      J[0] = g0 * pose[0] + g1 * pose[4] + g2 * pose[8];
      J[1] = g0 * pose[1] + g1 * pose[5] + g2 * pose[9];
      J[2] = g0 * pose[2] + g1 * pose[6] + g2 * pose[10];
      J[3] = J[2] * py - J[1] * pz;
      J[4] = J[0] * pz - J[2] * px;
      J[5] = J[1] * px - J[0] * py;
    } else {
      i_t = bilinear_at(a.img + b * plane, idx, a.W, du, dv);
      const float2* j = reinterpret_cast<const float2*>(a.J_ref) + bn * 3;
      const float2 j01 = __ldg(j), j23 = __ldg(j + 1), j45 = __ldg(j + 2);
      J[0] = j01.x; J[1] = j01.y; J[2] = j23.x;
      J[3] = j23.y; J[4] = j45.x; J[5] = j45.y;
    }
    const float i_ref = __ldg(a.ref_int + static_cast<size_t>(b) * a.ref_stride + i);
    float r = __fsub_rn(i_t, i_ref);
    if constexpr (AFFINE) {
      // (r - a I_ref) - b, rounded step by step as the plain version is.
      r = __fsub_rn(__fsub_rn(r, __fmul_rn(pose[12], i_ref)), pose[13]);
      J[6] = -i_ref;
      J[7] = -1.0f;
    }
    accumulate<n>(acc, J, r, sig, a.kind);
  }

  // Thread -> warp (shuffles) -> block (shared memory) -> pair (the
  // cluster's distributed shared memory), each in a fixed order.
#pragma unroll
  for (int i = 0; i < F::kSums; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[i] += __shfl_down_sync(0xffffffffu, acc[i], off);
    }
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int i = 0; i < F::kSums; ++i) warp_part[tid >> 5][i] = acc[i];
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
  for (int t = tid; t < F::kSums; t += blockDim.x) {
    float s = 0.0f;
    for (int wi = 0; wi < warps; ++wi) s += warp_part[wi][t];
    block_part[t] = s;
  }
  cluster.sync();
  if (cluster.block_rank() == 0) {
    float* o = a.out + static_cast<size_t>(b) * F::kOut;
    const unsigned blocks = cluster.num_blocks();
    for (int t = tid; t < F::kOut; t += blockDim.x) {
      if (t < F::kSums) {
        float s = 0.0f;
        for (unsigned rank = 0; rank < blocks; ++rank) {
          s += cluster.map_shared_rank(block_part, rank)[t];
        }
        if (t < F::kUpper) {
          int row, col;
          upper_index<n>(t, &row, &col);
          o[row * n + col] = s;
          o[col * n + row] = s;
        } else if (t < F::kUpper + n) {
          o[n * n + t - F::kUpper] = -s;
        } else {
          o[F::kTail + t - F::kUpper - n] = s;
        }
      } else if (t >= F::kTail + 3) {
        o[t] = 0.0f;
      }
    }
  }
  cluster.sync();   // the other blocks' shared memory lives until it is read
}

template <bool FC, bool AFFINE>
cudaError_t launch(const cudaLaunchConfig_t& cfg, const Args& a) {
  return cudaLaunchKernelEx(&cfg, lm_evaluate_kernel<FC, AFFINE>, a);
}

}  // namespace

// img: IC (fc == 0) one plane per pair (B, H, W), with J_ref (B, N, 6); FC
// texels (B, H, W, 4), J_ref unused. ab: (B, 2) brightness with affine != 0,
// unused without. ref_int: B rows of N, ref_stride floats apart. out: (B, 48),
// or (B, 80) with affine. kind: 0 none, 1 Huber. A pair's points go to a
// cluster of `blocks` (1, 2, 4 or 8) blocks of `threads` (a multiple of 32, at
// most 1024, or 256 with affine) threads, which strides over them.
extern "C" int uws_lm_evaluate(const float* img, const float* p3d,
                               const float* T, const float* ab,
                               const float* ref_int, const uint8_t* pts_valid,
                               const float* J_ref, const float* sigma,
                               float* out, int B, int H, int W, int N,
                               int ref_stride, float fx, float fy, float cx,
                               float cy, int fc, int affine, int kind,
                               int threads, int blocks, void* stream) {
  const int max_threads =
      affine ? Form<true>::kMaxThreads : Form<false>::kMaxThreads;
  if (threads < 32 || threads > max_threads || threads % 32 != 0 ||
      blocks < 1 || blocks > kMaxCluster || (blocks & (blocks - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const Args a{img, p3d, T, ab, ref_int, pts_valid, J_ref, sigma, out,
               H, W, N, ref_stride, Intrinsics{fx, fy, cx, cy}, kind};
  const cudaError_t err =
      fc ? (affine ? launch<true, true>(cfg, a) : launch<true, false>(cfg, a))
         : (affine ? launch<false, true>(cfg, a) : launch<false, false>(cfg, a));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
