// lm_step: the Levenberg-Marquardt update of a batch of frame pairs after one
// evaluation, in one launch. It replaces no TPU kernel: on the TPU, XLA fuses
// the loop body of uwslam_tpu/tracking/photometric.py (the accept test, the
// damped 6 x 6 or 8 x 8 Cholesky solve, se3 exp, compose and normalize, the
// masked selects) into a few fused ops; eager PyTorch ran it as ~300 launches
// of a few floats each per iteration (~480 with affine brightness), which a
// CUDA graph replays one after another at ~1.1 us of launch latency each.
//
// One thread per pair, everything in registers. The thread reads the pair's
// sums of the candidate's evaluation straight from lm_evaluate's output
// (48 floats, or 80 with affine brightness: H row-major n x n, b, the cost,
// sum |r|, the valid count), forms err = cost / max(count, 1) and runs the
// body of tracking/photometric.py:lm_step in its order:
//   active = !done && k < max_iters; accept = err < error && isfinite(err);
//   the base state (the candidate's on accept, the best one's else);
//   lam' = clamp(accept ? lam / 2 : 4 lam, 1e-7, 1e3);
//   delta = (H + lam' diag(H) + 1e-8 I)^-1 b by utils/linalg.py's unrolled
//   Cholesky, pivots clamped at 1e-20; ok = all finite(delta);
//   T' = normalize(T_base exp(delta[:6])) where ok (lie/so3.py's Taylor
//   branches at _EPS2, the Frobenius rescale and two Newton steps);
//   (a, b)' = (a, b)_base + delta[6:] where ok (affine form);
//   done' = (accept && |delta| < eps) || lam' > 500 || !ok;
// and commits the step only where active. The init form does what precedes
// the loop: lam = init_lambda, delta0 from the first sums, T = normalize(T0
// exp(delta0)), (a, b) = (a, b)0 + delta0[6:], the best state (T0, (a, b)0,
// the first sums, their error and count), k = 0, done = false.
//
// Every multiply, add and subtract is an explicitly rounded intrinsic (no
// contraction to FMA), in the plain PyTorch version's order; division and
// sqrtf are IEEE (no fast math), sinf / cosf the accurate ones. Sums over
// k run from k = 0 up, as the CPU's small batched matmul does. So err, the
// accept test and the damping are exact, and the solve and the pose agree
// with the plain version to the rounding of its library matmuls and sin/cos.
//
// Bound on the card: the launch itself (B = 1: one thread; B = 95: one
// block). Its work is ~1,000 f32 operations per pair; what it removes is the
// ~300 dependent launches per iteration that the graph replayed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kEps2 = 1e-12f;       // lie/so3.py: _EPS ** 2
constexpr float kPivot = 1e-20f;      // utils/linalg.py: the Cholesky's pivot clamp
constexpr float kRidge = 1e-8f;       // tracking/photometric.py: _solve_damped's
constexpr float kLamMin = 1e-7f, kLamMax = 1e3f, kLamDone = 500.0f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp: NaN stays NaN.
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// C = A B for 3 x 3 or 4 x 4 row-major matrices, each entry summed from 0
// over k = 0, 1, ...
template <int m>
__device__ __forceinline__ void matmul(const float (&A)[m][m], const float (&B)[m][m],
                                       float (&C)[m][m]) {
#pragma unroll
  for (int i = 0; i < m; ++i) {
#pragma unroll
    for (int j = 0; j < m; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < m; ++k) s = add(s, mul(A[i][k], B[k][j]));
      C[i][j] = s;
    }
  }
}

// (H + lam diag(H) + 1e-8 I) x = g by tracking/photometric.py:_solve_damped
// and utils/linalg.py:cholesky_solve_unrolled. H: n x n row-major.
template <int n>
__device__ __forceinline__ void solve_damped(const float* H, const float* g, float lam,
                                             float (&x)[n]) {
  float L[n][n];
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float h = H[i * n + j];
      // Off the diagonal the plain version adds lam * 0 and 1e-8 * 0.
      float s = i == j ? add(add(h, mul(lam, h)), kRidge) : add(add(h, 0.0f), 0.0f);
#pragma unroll
      for (int k = 0; k < j; ++k) s = sub(s, mul(L[i][k], L[j][k]));
      L[i][j] = i == j ? sqrtf(s < kPivot ? kPivot : s) : s / L[j][j];
    }
  }
  float y[n];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = sub(s, mul(L[i][k], y[k]));
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = n - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < n; ++k) s = sub(s, mul(L[k][i], x[k]));
    x[i] = s / L[i][i];
  }
}

// lie/se3.py:exp of the twist [v, w]: R = I + a W + b W^2, t = (I + b W +
// c W^2) v, with so3.py's sinc, cosc and left-Jacobian coefficients.
__device__ __forceinline__ void se3_exp(const float* xi, float (&E)[4][4]) {
  const float v[3] = {xi[0], xi[1], xi[2]};
  const float w[3] = {xi[3], xi[4], xi[5]};
  const float theta2 = add(add(add(0.0f, mul(w[0], w[0])), mul(w[1], w[1])), mul(w[2], w[2]));
  const bool small = theta2 < kEps2;
  const float t = sqrtf(small ? 1.0f : theta2);
  const float sinc = small ? sub(1.0f, theta2 / 6.0f) : sinf(t) / t;
  const float cosc = small ? sub(0.5f, theta2 / 24.0f) : sub(1.0f, cosf(t)) / theta2;
  const float c = small ? sub(static_cast<float>(1.0 / 6.0), theta2 / 120.0f)
                        : sub(1.0f, sinc) / theta2;
  const float W[3][3] = {{0.0f, -w[2], w[1]}, {w[2], 0.0f, -w[0]}, {-w[1], w[0], 0.0f}};
  float W2[3][3];
  matmul<3>(W, W, W2);
  float J[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      E[i][j] = add(add(eye, mul(sinc, W[i][j])), mul(cosc, W2[i][j]));
      J[i][j] = add(add(eye, mul(cosc, W[i][j])), mul(c, W2[i][j]));
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    E[i][3] = add(add(add(0.0f, mul(J[i][0], v[0])), mul(J[i][1], v[1])), mul(J[i][2], v[2]));
    E[3][i] = 0.0f;
  }
  E[3][3] = 1.0f;
}

// lie/se3.py:normalize(compose(T, exp(xi))) into out (16 floats, row-major):
// the rotation de-scaled by its Frobenius estimate, then two Newton steps
// R <- R (1.5 I - 0.5 R^T R).
__device__ __forceinline__ void apply_delta(const float (&T)[4][4], const float* xi,
                                            float* out) {
  float E[4][4], P[4][4];
  se3_exp(xi, E);
  matmul<4>(T, E, P);
  float fro = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) fro = add(fro, mul(P[i][j], P[i][j]));
  }
  fro = sqrtf(fro / 3.0f);
  const float scale = fro < 1e-12f ? 1e-12f : fro;
  float R[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = P[i][j] / scale;
  }
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    float Rt[3][3], RtR[3][3], M[3][3], Rn[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) Rt[i][j] = R[j][i];
    }
    matmul<3>(Rt, R, RtR);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        M[i][j] = sub(mul(1.5f, i == j ? 1.0f : 0.0f), mul(0.5f, RtR[i][j]));
      }
    }
    matmul<3>(R, M, Rn);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = Rn[i][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i * 4 + j] = R[i][j];
    out[i * 4 + 3] = P[i][3];
    out[12 + i] = 0.0f;
  }
  out[15] = 1.0f;
}

struct State {
  float* T;            // (B, 4, 4) the candidate to evaluate next
  float* ab;           // (B, 2) its brightness (affine form)
  float* T_best;       // (B, 4, 4) the best accepted state
  float* ab_best;      // (B, 2)
  float* s_best;       // (B, width) its sums
  float* error;        // (B,)
  float* lam;          // (B,)
  long long* k;        // (B,) iterations run
  uint8_t* done;       // (B,) bool
  long long* n_inlier; // (B,) valid count of the best state
};

struct Args {
  const float* sums;   // (B, width) the candidate's evaluation
  State s;
  const float* T0;     // init form: the level's initial pose and brightness
  const float* ab0;
  int B, max_iters;
  float eps, init_lambda;
};

template <int n>
__global__ void __launch_bounds__(kThreads) lm_step_kernel(Args a, bool init) {
  constexpr int width = n == 8 ? 80 : 48;
  constexpr int cost = n * n + n;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const State& s = a.s;
  const float* sums = a.sums + static_cast<size_t>(b) * width;
  float* s_best = s.s_best + static_cast<size_t>(b) * width;
  const float count = sums[cost + 2];
  const float err = sums[cost] / (count < 1.0f ? 1.0f : count);
  const long long n_valid = static_cast<long long>(count);
  float T[4][4];
  float delta[n];

  if (init) {
    const float lam = a.init_lambda;
    solve_damped<n>(sums, sums + n * n, lam, delta);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      T[i / 4][i % 4] = a.T0[b * 16 + i];
      s.T_best[b * 16 + i] = T[i / 4][i % 4];
    }
    apply_delta(T, delta, s.T + b * 16);
    if constexpr (n == 8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s.ab_best[b * 2 + i] = a.ab0[b * 2 + i];
        s.ab[b * 2 + i] = add(a.ab0[b * 2 + i], delta[6 + i]);
      }
    }
    for (int i = 0; i < width; ++i) s_best[i] = sums[i];
    s.error[b] = err;
    s.lam[b] = lam;
    s.k[b] = 0;
    s.done[b] = 0;
    s.n_inlier[b] = n_valid;
    return;
  }

  if (s.done[b] || s.k[b] >= a.max_iters) return;     // not active: nothing changes
  const bool accept = err < s.error[b] && isfinite(err);
  const float* base = accept ? s.T : s.T_best;
#pragma unroll
  for (int i = 0; i < 16; ++i) T[i / 4][i % 4] = base[b * 16 + i];
  const float lam = s.lam[b];
  const float lam_next = clamp(accept ? mul(lam, 0.5f) : mul(lam, 4.0f), kLamMin, kLamMax);
  const float* s_base = accept ? sums : s_best;
  solve_damped<n>(s_base, s_base + n * n, lam_next, delta);
  bool ok = true;
  float norm2 = 0.0f;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    ok = ok && isfinite(delta[i]);
    norm2 = add(norm2, mul(delta[i], delta[i]));
  }
  const bool small = sqrtf(norm2) < a.eps;
  if (accept) {
    for (int i = 0; i < width; ++i) s_best[i] = sums[i];
    s.error[b] = err;
    s.n_inlier[b] = n_valid;
  }
  // T_best <- T_base; T <- T_next (T_base where the step is not finite).
#pragma unroll
  for (int i = 0; i < 16; ++i) s.T_best[b * 16 + i] = T[i / 4][i % 4];
  if (ok) {
    apply_delta(T, delta, s.T + b * 16);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) s.T[b * 16 + i] = T[i / 4][i % 4];
  }
  if constexpr (n == 8) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float ab_base = accept ? s.ab[b * 2 + i] : s.ab_best[b * 2 + i];
      s.ab_best[b * 2 + i] = ab_base;
      s.ab[b * 2 + i] = ok ? add(ab_base, delta[6 + i]) : ab_base;
    }
  }
  s.lam[b] = lam_next;
  s.k[b] += 1;
  s.done[b] = (accept && small) || lam_next > kLamDone || !ok;
}

}  // namespace

// sums: (B, 48), or (B, 80) with affine != 0, as lm_evaluate writes them.
// State buffers as struct State says (ab and ab_best unused without affine);
// T0, ab0: the init form's inputs (init != 0), unused otherwise. One thread
// per pair.
extern "C" int uws_lm_step(const float* sums, float* T, float* ab, float* T_best,
                           float* ab_best, float* s_best, float* error, float* lam,
                           long long* k, uint8_t* done, long long* n_inlier,
                           const float* T0, const float* ab0, int B, int affine,
                           int max_iters, float eps, float init_lambda, int init,
                           void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{sums, State{T, ab, T_best, ab_best, s_best, error, lam, k, done, n_inlier},
               T0, ab0, B, max_iters, eps, init_lambda};
  const dim3 grid((B + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (affine) {
    lm_step_kernel<8><<<grid, kThreads, 0, st>>>(a, init != 0);
  } else {
    lm_step_kernel<6><<<grid, kThreads, 0, st>>>(a, init != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
