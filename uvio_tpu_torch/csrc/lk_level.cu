// One pyramid level of Lucas-Kanade for a batch of features, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lk_level_pallas` in
// uvio_tpu/frontend/pallas_kernels.py, under both of its variants
// (`_lk_kernel_batched`, the default, and `_lk_kernel`, batched=False):
// they compute the same function. Contract: `klt.lk_level`
// (uvio_tpu/frontend/klt.py:187-246), including `_bilinear_patch`'s
// clipping of the window start to [0, W-P-1] x [0, H-P-1] and its
// in-bounds test. Per feature: a bilinear P x P template (P = 2*half+1)
// at uv_prev in img_prev, central-difference gradients with zeroed
// edges, the 2x2 structure tensor with det > 1e-6 and a min-eigenvalue
// gate, `iters` Gauss-Newton steps on bilinear windows of img_next, and
// ok = valid & in-bounds & ok-every-iteration & good & eig >= min_eig.
// The Pallas kernel's +-6 px search-slab limit (a VMEM artefact) is not
// carried over: every iteration samples wherever the estimate is.
//
// Bound: latency and launch. 150 features x 4 levels is a few hundred
// kB of bilinear reads per frame; the pyramid (1.9 MB at 752x480) stays
// resident in the 50 MB L2, so the cost is the dependent chain of
// `iters` block-wide reductions per feature. Design: one CTA per
// feature, one thread per patch pixel (225 of 256 at half = 7), the
// template in shared memory for the gradients, warp-shuffle + shared
// block sums for Gxx/Gxy/Gyy and bx/by. Bilinear blends use
// round-to-nearest intrinsics so they are never contracted to FMA and
// round exactly like the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 15;  // half <= 7

__device__ __forceinline__ float bilinear(const float* __restrict__ img, int W, int x, int y,
                                          float fx, float fy) {
  const float* row0 = img + y * W + x;
  const float* row1 = row0 + W;
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;
  const float top = __fadd_rn(__fmul_rn(row0[0], gx), __fmul_rn(row0[1], fx));
  const float bot = __fadd_rn(__fmul_rn(row1[0], gx), __fmul_rn(row1[1], fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide sums of up to three values; every thread gets the totals.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float (*s_part)[3], float* s_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) s_part[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float t = 0.0f;
      for (int w = 0; w < kWarps; ++w) t += s_part[w][k];
      s_tot[k] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = s_tot[k];
}

struct Window {
  int x, y;      // clipped integer start of the (P+1)^2 block
  float fx, fy;  // fractional offsets
  bool in_bounds;
};

__device__ __forceinline__ Window window_at(float u, float v, int half, int P, int H, int W) {
  Window w;
  const float fu = floorf(u);
  const float fv = floorf(v);
  const int x0 = static_cast<int>(fu) - half;
  const int y0 = static_cast<int>(fv) - half;
  w.fx = u - fu;
  w.fy = v - fv;
  w.in_bounds = x0 >= 0 && y0 >= 0 && x0 + P + 1 < W && y0 + P + 1 < H;
  w.x = min(max(x0, 0), W - P - 1);
  w.y = min(max(y0, 0), H - P - 1);
  return w;
}

__global__ void __launch_bounds__(kThreads)
lk_level_kernel(const float* __restrict__ img_prev, const float* __restrict__ img_next, int H,
                int W, const float* __restrict__ uv_prev, const float* __restrict__ uv_guess,
                const unsigned char* __restrict__ valid, float* __restrict__ uv_out,
                unsigned char* __restrict__ ok_out, int half, int iters, float min_eig) {
  __shared__ float s_tmpl[kMaxP * kMaxP];
  __shared__ float s_part[kWarps][3];
  __shared__ float s_tot[3];

  const int n = blockIdx.x;
  const int P = 2 * half + 1;
  const int t = threadIdx.x;
  const bool active = t < P * P;
  const int r = active ? t / P : 0;
  const int c = active ? t % P : 0;

  // ---- template at uv_prev in img_prev ----
  const Window tw = window_at(uv_prev[2 * n], uv_prev[2 * n + 1], half, P, H, W);
  const float tv = active ? bilinear(img_prev, W, tw.x + c, tw.y + r, tw.fx, tw.fy) : 0.0f;
  if (active) s_tmpl[t] = tv;
  __syncthreads();
  float gx = 0.0f, gy = 0.0f;
  if (active) {
    if (c > 0 && c < P - 1) gx = 0.5f * (s_tmpl[t + 1] - s_tmpl[t - 1]);
    if (r > 0 && r < P - 1) gy = 0.5f * (s_tmpl[t + P] - s_tmpl[t - P]);
  }
  float G[3] = {gx * gx, gx * gy, gy * gy};
  block_sum<3>(G, s_part, s_tot);
  const float Gxx = G[0], Gxy = G[1], Gyy = G[2];
  const float det = Gxx * Gyy - Gxy * Gxy;
  const float eig = 0.5f * (Gxx + Gyy - sqrtf((Gxx - Gyy) * (Gxx - Gyy) + 4.0f * Gxy * Gxy));
  const bool good = det > 1e-6f;
  const float safe_det = good ? det : 1.0f;

  // ---- Gauss-Newton iterations on img_next ----
  float qx = uv_guess[2 * n];
  float qy = uv_guess[2 * n + 1];
  bool ok_iter = tw.in_bounds;
  for (int it = 0; it < iters; ++it) {
    const Window w = window_at(qx, qy, half, P, H, W);
    const float cur = active ? bilinear(img_next, W, w.x + c, w.y + r, w.fx, w.fy) : 0.0f;
    const float err = cur - tv;
    float b[2] = {gx * err, gy * err};
    block_sum<2>(b, s_part, s_tot);
    const float dx = __fdiv_rn(__fsub_rn(__fmul_rn(Gyy, b[0]), __fmul_rn(Gxy, b[1])), safe_det);
    const float dy = __fdiv_rn(__fsub_rn(__fmul_rn(Gxx, b[1]), __fmul_rn(Gxy, b[0])), safe_det);
    if (good && w.in_bounds) {
      qx -= dx;
      qy -= dy;
    }
    ok_iter = ok_iter && w.in_bounds;
  }
  if (t == 0) {
    uv_out[2 * n] = qx;
    uv_out[2 * n + 1] = qy;
    ok_out[n] = (valid[n] != 0) && tw.in_bounds && ok_iter && good && eig >= min_eig;
  }
}

}  // namespace

// img_prev/img_next: (H, W) float32; uv_prev/uv_guess/uv_out: (N, 2)
// float32; valid/ok_out: (N,) bytes (torch.bool); all contiguous on the
// device, half <= 7. Launches on `stream`, returns cudaGetLastError().
extern "C" int uvio_lk_level(const float* img_prev, const float* img_next, int H, int W,
                             const float* uv_prev, const float* uv_guess,
                             const unsigned char* valid, float* uv_out, unsigned char* ok_out,
                             int N, int half, int iters, float min_eig, cudaStream_t stream) {
  if (N == 0) return 0;
  lk_level_kernel<<<N, kThreads, 0, stream>>>(img_prev, img_next, H, W, uv_prev, uv_guess, valid,
                                              uv_out, ok_out, half, iters, min_eig);
  return static_cast<int>(cudaGetLastError());
}
