// The pyramid kernel: a frame batch's whole image pyramid in one launch.
//
// Replaces the TPU kernel uwslam_tpu/ops/pallas_pyramid.py:_scharr_kernel
// (launched by scharr_gradients_batched once per level), and the plain 2x2
// mean downsample that ran between its launches. For a (B, H, W) batch and
// `levels` levels it writes
//   - the images of levels 1 .. levels-1, each pixel the 2x2 mean of the
//     level above: ((x00 + x01) + x10) + x11, times 0.25;
//   - gx, gy and gm of every level, by K1's edge-replicated 3x3 Scharr:
//       gx = (3(c-a) + 10(f-d) + 3(i-g)) / 32
//       gy = (3(g-a) + 10(h-b) + 3(i-c)) / 32
//       gm = 0.5|gx| + 0.5|gy|
//     for taps a b c / d . f / g h i, replicated at that level's own border.
// With levels = 1 it is K1 alone (scharr_gradients_batched).
//
// Bound on the card: HBM bytes. The input is read once and every output
// written once: 628.5 MB for 96 x 480 x 640 at 5 levels, 0.188 ms at
// 3.35 TB/s; one level-by-level launch per field would also re-read every
// level it wrote. Design: a block owns a T x T tile of level 0 (T a multiple
// of 2^(levels-1), so the tile covers whole pixels of every level) and builds
// every level of it in shared memory. A level-l pixel covers 2^l x 2^l
// level-0 pixels, so one pixel of Scharr halo at the last level needs
// h0 = 2^(levels-1) level-0 pixels of halo: the block stages the
// (T + 2 h0)^2 level-0 region with cp.async (clamped addresses replicate the
// border), then each level's region (side (T + 2 h0) / 2^l, halo h0 / 2^l)
// is the mean of the one above, taken at positions clamped to that level's
// border, so halos replicate at level l's edge, not level 0's. Neighbouring
// tiles' halos overlap; they are re-read from L2, not HBM. The wrapper picks
// T = 64 where the batch gives enough tiles to fill the 132 SMs several
// times over and T = 32 otherwise (a single 480 x 640 frame: 300 blocks).
// Threads walk rows with consecutive lanes on consecutive columns, so shared
// memory reads are free of bank conflicts and every warp stores whole 128 B
// lines. A single frame's blocks all fit on the card at once, so its time is
// one block's chain of dependent steps (the staged load, then one level
// after another), not its bytes: 512 threads a block and 16-byte staging
// copies, tried to shorten that chain, measured slower at every shape.
//
// Every add and multiply is an explicitly rounded intrinsic in the plain
// version's order (nvcc may not contract them into FMAs), so the result
// equals the plain PyTorch version (uwslam_tpu_torch/ops/cuda_pyramid.py)
// bit for bit: the point selection picks pixels by exact gm.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 5;
constexpr int kMaxSharedBytes = 64 * 1024;   // T = 64 at 5 levels needs 49,104 B

struct Layout {
  int levels, tile, log_tile;
  int H[kMaxLevels], W[kMaxLevels];
  long long img_off[kMaxLevels];    // level l's images in `out_img` (l >= 1)
  long long grad_off[kMaxLevels];   // level l's gradients in gx, gy, gm
};

// 3(p - q) + 10(r - s) + 3(t - w), summed left to right, then / 32.
__device__ __forceinline__ float scharr(float p, float q, float r, float s,
                                        float t, float w) {
  float acc = __fmul_rn(3.0f, __fsub_rn(p, q));
  acc = __fadd_rn(acc, __fmul_rn(10.0f, __fsub_rn(r, s)));
  acc = __fadd_rn(acc, __fmul_rn(3.0f, __fsub_rn(t, w)));
  return __fmul_rn(acc, 0.03125f);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int clamp(int v, int hi) { return min(max(v, 0), hi); }

__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const float* __restrict__ img, float* __restrict__ out_img,
               float* __restrict__ gx, float* __restrict__ gy,
               float* __restrict__ gm, const Layout L) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z;
  int T = L.tile, log_t = L.log_tile;
  int h = 1 << (L.levels - 1);
  int R = T + 2 * h;
  int y0 = blockIdx.y * T, x0 = blockIdx.x * T;

  // Level 0's region, rows [y0 - h, y0 + T + h), clamped to the frame.
  {
    const int H0 = L.H[0], W0 = L.W[0];
    const float* f = img + static_cast<size_t>(b) * H0 * W0;
    for (int i = warp; i < R; i += kWarps) {
      const float* row = f + static_cast<size_t>(clamp(y0 - h + i, H0 - 1)) * W0;
      for (int j = lane; j < R; j += 32)
        cp_async4(smem + i * R + j, row + clamp(x0 - h + j, W0 - 1));
    }
    cp_async_wait_all();
    __syncthreads();
  }

  float* cur = smem;
  for (int l = 0; l < L.levels; ++l) {
    const int Hl = L.H[l], Wl = L.W[l];
    float* next = cur + R * R;
    // Level l+1's region from level l's: position p of level l+1 (halo h/2)
    // is the mean of level l's pixels 2c, 2c+1 with c = p clamped to the
    // frame at level l+1; those lie inside level l's region and the frame.
    if (l + 1 < L.levels) {
      const int Rn = R >> 1, hn = h >> 1, yn = y0 >> 1, xn = x0 >> 1;
      const int Hn = L.H[l + 1] - 1, Wn = L.W[l + 1] - 1;
      for (int i = warp; i < Rn; i += kWarps) {
        const float* src = cur + 2 * (clamp(yn - hn + i, Hn) - yn + hn) * R;
        for (int j = lane; j < Rn; j += 32) {
          const float* p = src + 2 * (clamp(xn - hn + j, Wn) - xn + hn);
          const float s = __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), p[R]), p[R + 1]);
          next[i * Rn + j] = __fmul_rn(s, 0.25f);
        }
      }
    }
    // Level l's Scharr over the tile (and, below level 0, its image).
    const int th = min(T, Hl - y0), tw = min(T, Wl - x0);
    const size_t frame = static_cast<size_t>(b) * Hl * Wl;
    float* ox = gx + L.grad_off[l] + frame;
    float* oy = gy + L.grad_off[l] + frame;
    float* om = gm + L.grad_off[l] + frame;
    float* oi = l > 0 ? out_img + L.img_off[l] + frame : nullptr;
    for (int k = threadIdx.x; k < (T << log_t); k += kThreads) {
      const int ty = k >> log_t, tx = k & (T - 1);
      if (ty >= th || tx >= tw) continue;
      const float* c = cur + (h + ty) * R + h + tx;
      const float a = c[-R - 1], bb = c[-R], cc = c[-R + 1];
      const float d = c[-1], e = c[1];
      const float g = c[R - 1], hh = c[R], ii = c[R + 1];
      const float vx = scharr(cc, a, e, d, ii, g);
      const float vy = scharr(g, a, hh, bb, ii, cc);
      const size_t o = static_cast<size_t>(y0 + ty) * Wl + x0 + tx;
      ox[o] = vx;
      oy[o] = vy;
      om[o] = __fadd_rn(__fmul_rn(0.5f, fabsf(vx)), __fmul_rn(0.5f, fabsf(vy)));
      if (oi != nullptr) oi[o] = c[0];
    }
    __syncthreads();
    cur = next;
    R >>= 1;
    h >>= 1;
    T >>= 1;
    log_t -= 1;
    y0 >>= 1;
    x0 >>= 1;
  }
}

// Shared memory of one block: the regions of all levels, sides (T + 2 h0) / 2^l
// (`shared_bytes` in ops/cuda_pyramid.py).
int shared_bytes(int levels, int tile) {
  int side = tile + 2 * (1 << (levels - 1)), total = 0;
  for (int l = 0; l < levels; ++l, side >>= 1) total += side * side;
  return total * static_cast<int>(sizeof(float));
}

}  // namespace

// img (B, H, W); out_img: levels 1 .. levels-1 back to back, each (B, H_l, W_l);
// gx, gy, gm: levels 0 .. levels-1 back to back. H and W divisible by
// 2^(levels-1), tile a power of two and a multiple of it (the wrapper checks).
extern "C" int uws_pyramid(const float* img, float* out_img, float* gx, float* gy,
                           float* gm, int B, int H, int W, int levels, int tile,
                           void* stream) {
  if (levels < 1 || levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  Layout L{};
  L.levels = levels;
  L.tile = tile;
  while ((1 << L.log_tile) < tile) ++L.log_tile;
  long long img_off = 0, grad_off = 0;
  for (int l = 0; l < levels; ++l) {
    L.H[l] = H >> l;
    L.W[l] = W >> l;
    L.img_off[l] = img_off;
    L.grad_off[l] = grad_off;
    const long long n = static_cast<long long>(B) * L.H[l] * L.W[l];
    if (l > 0) img_off += n;
    grad_off += n;
  }
  const int shared = shared_bytes(levels, tile);
  if (shared > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile, B);
  pyramid_kernel<<<grid, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      img, out_img, gx, gy, gm, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* uws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
