// Pyramidal Lucas-Kanade for a batch of features in one launch, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lk_level_pallas` in
// uvio_tpu/frontend/pallas_kernels.py (both of its bodies,
// `_lk_kernel_batched` and `_lk_kernel`, compute the same function)
// together with the level loop around it, `klt.lk_track`
// (uvio_tpu/frontend/klt.py:249-290). Per level the contract is
// `klt.lk_level` (klt.py:187-246), including `_bilinear_patch`'s clipping
// of the window start to [0, W-P-1] x [0, H-P-1] and its in-bounds test:
// a bilinear P x P template (P = 2*half+1) at uv_prev in img_prev,
// central-difference gradients with zeroed edges, the 2x2 structure
// tensor with det > 1e-6 and a min-eigenvalue gate, `iters` Gauss-Newton
// steps on bilinear windows of img_next, and
// ok = valid & in-bounds & ok-every-iteration & good & eig >= min_eig.
// Between levels, as `lk_track` does: uv_prev / 2^lev, guess * 2 (both
// exact in float32), min(iters, coarse_iters) iterations and min_eig = 0
// above level 0, and the ok mask of level 0. The Pallas kernel's +-6 px
// search-slab limit is not carried over: the search is unbounded.
//
// Bound: neither bytes nor operations but latency. A frame's 150
// features touch about a megabyte of an L2-resident pyramid and do about
// 13 MFLOP, a fraction of a microsecond of the card either way; the cost
// is each feature's dependent chain of 28 Gauss-Newton iterations
// (sample, 225-term sums, 2x2 solve, next window). The design shortens
// the chain and takes everything else off it:
//   * one CTA per feature walks all levels, so a frame is one launch and
//     the inter-level algebra never returns to the host;
//   * phase A computes every level's template, gradients and structure
//     tensor up front into shared memory and stages per level a
//     (P+1+2*8)^2 slab of img_next around the level's first guess (the
//     caller's, else zero flow) with coalesced loads: all global loads
//     of a feature are in flight at once, before the chain starts;
//   * phase B iterates out of the slabs; a window that leaves its slab
//     (a flow beyond the 8-px margin at that level) restages it around
//     the current estimate, so the search stays unbounded;
//   * the sums of an iteration take at most one barrier and no serial
//     loop by one thread: the CTA's 4 warps own 2 pixels a thread,
//     shuffle within the warp, and then every thread adds the 4 warp
//     partials in the same fixed order out of a double buffer. Chains of
//     1 (8 pixels a lane, shuffles only, no barrier), 2, 4 and 8 warps
//     were timed on an H100: about 28.5, 27.0, 23.7 and 24.2 us a frame
//     (PERF.md, section 6), so the chain has 4.
// What is left is the chain itself: about 140 dependent operations an
// iteration (floor and convert, shared loads, the blend, five shuffle
// stages, a barrier, two IEEE divisions), 0.7 us each time.
// Blends, products and sums use round-to-nearest intrinsics, so nothing
// is contracted to FMA and only the order of the 225-term sums differs
// from the plain PyTorch version. `uvio_lk_level` (one level, caller's
// guess) launches the same kernel with one level, so one `uvio_lk_track`
// launch equals the chain of `uvio_lk_level` launches bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kSlots = 256;             // pixel slots of a CTA, >= 15 * 15
constexpr int kWarps = 4;               // warps of a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kPix = kSlots / kThreads; // pixels a thread owns
constexpr int kMargin = 8;              // slab margin around the window
constexpr int kSlabMax = 32;            // (2*7+1) + 1 + 2*kMargin
constexpr int kSlabStride = kSlabMax + 1;
constexpr int kLevelFloats = 3 * kSlots + kSlabMax * kSlabStride;  // shared floats of a level

struct Pyramid {
  const float* prev[kMaxLevels];
  const float* next[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
  int levels;
};

struct LevelInfo {
  float Gxx, Gxy, Gyy, safe_det, eig;
  int good, in_bounds;
  int H, W;      // of the level's images
  int sx0, sy0;  // origin of the slab staged in phase A
};

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

// Bilinear sample of the 2x2 block at p[i] (row stride `stride`). The
// shared slabs are read as `s_levels[i]`, an index and not a pointer, so
// the loads address shared memory directly.
template <typename Ptr>
__device__ __forceinline__ float bilinear(Ptr p, int i, int stride, float fx, float fy) {
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;
  const float top = __fadd_rn(__fmul_rn(p[i], gx), __fmul_rn(p[i + 1], fx));
  const float bot = __fadd_rn(__fmul_rn(p[i + stride], gx), __fmul_rn(p[i + stride + 1], fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
}

// Sums of NV values over the CTA; every thread gets bitwise the same
// totals. The xor butterfly adds the same two group sums in every lane
// of a pair, so a warp's lanes agree; across warps every thread adds the
// warp partials in index order. `s_part` is double-buffered by `flip`, so
// one barrier per call is enough.
template <int NV>
__device__ __forceinline__ void cta_sum(float (&v)[NV], float (*s_part)[kWarps][3], int& flip) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = __fadd_rn(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) s_part[flip][warp][k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float t = s_part[flip][0][k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, s_part[flip][w][k]);
    v[k] = t;
  }
  flip ^= 1;
}

// Slab origin along one axis for a window starting at `w0`: kMargin
// before it, kept inside the image (`n` pixels, slab extent `s` <= n).
__device__ __forceinline__ int slab_origin(int w0, int s, int n) {
  return min(max(w0 - kMargin, 0), n - s);
}

// Stages the sh x sw slab of `img` (row length W) that starts at
// (sx0, sy0); S is the slab's nominal side, sw <= S.
__device__ __forceinline__ void stage_slab(float* slab, const float* __restrict__ img, int W,
                                           int sx0, int sy0, int sw, int sh, int S, int tt) {
  for (int i = tt; i < sh * S; i += kThreads) {
    const int r = i / S;
    const int c = i % S;
    if (c < sw) slab[r * kSlabStride + c] = img[(sy0 + r) * W + sx0 + c];
  }
}

// HALF > 0: patch half-width known at compile time; HALF == 0: `half_rt`.
// Dynamic shared memory: kLevelFloats floats per level.
template <int HALF>
__global__ void __launch_bounds__(kThreads)
lk_kernel(Pyramid pyr, const float* __restrict__ uv_prev, const float* __restrict__ uv_guess,
          const unsigned char* __restrict__ valid, float* __restrict__ uv_out,
          unsigned char* __restrict__ ok_out, int half_rt, int iters, int coarse_iters,
          float min_eig) {
  extern __shared__ float s_levels[];  // per level: template, gx, gy, slab
  __shared__ float s_part[2][kWarps][3];
  __shared__ LevelInfo s_info[kMaxLevels];

  const int half = HALF > 0 ? HALF : half_rt;
  const int P = 2 * half + 1;
  const int S = P + 1 + 2 * kMargin;  // slab extent, <= kSlabMax
  const int n = blockIdx.x;
  const int tt = threadIdx.x;
  const int L = pyr.levels;
  int flip = 0;

  // the pixels this thread owns, the same at every level; a slot past the
  // patch samples pixel (0, 0) with zero gradients, so it adds nothing
  int pr[kPix], pc[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int id = tt * kPix + k;
    pr[k] = id < P * P ? id / P : 0;
    pc[k] = id < P * P ? id % P : 0;
  }
  const float u0 = uv_prev[2 * n];
  const float v0 = uv_prev[2 * n + 1];

  // ---- phase A: per level the template, its gradients and structure
  // tensor, and the slab of img_next around the level's first guess (the
  // caller's, else zero flow); every global load of it is in flight at once
  for (int lev = 0; lev < L; ++lev) {
    float* s_tmpl = s_levels + lev * kLevelFloats;
    const float sc = 1.0f / static_cast<float>(1 << lev);
    const int H = pyr.H[lev];
    const int W = pyr.W[lev];
    const Window tw = window_at(u0 * sc, v0 * sc, half, P, H, W);
    const float* base = pyr.prev[lev] + tw.y * W + tw.x;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int id = tt * kPix + k;
      if (id < P * P) s_tmpl[id] = bilinear(base, pr[k] * W + pc[k], W, tw.fx, tw.fy);
    }
    const bool given = uv_guess != nullptr;
    const Window gw = window_at(given ? uv_guess[2 * n] : u0 * sc,
                                given ? uv_guess[2 * n + 1] : v0 * sc, half, P, H, W);
    const int sw = min(S, W);  // slab extent inside a small image
    const int sh = min(S, H);
    const int sx0 = slab_origin(gw.x, sw, W);
    const int sy0 = slab_origin(gw.y, sh, H);
    stage_slab(s_tmpl + 3 * kSlots, pyr.next[lev], W, sx0, sy0, sw, sh, S, tt);
    if (tt == 0) {
      s_info[lev].in_bounds = tw.in_bounds;
      s_info[lev].H = H;
      s_info[lev].W = W;
      s_info[lev].sx0 = sx0;
      s_info[lev].sy0 = sy0;
    }
  }
  __syncthreads();
  for (int lev = 0; lev < L; ++lev) {
    float* s_tmpl = s_levels + lev * kLevelFloats;
    float G[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int id = tt * kPix + k;
      float gx = 0.0f, gy = 0.0f;
      if (id < P * P) {
        if (pc[k] > 0 && pc[k] < P - 1) gx = 0.5f * (s_tmpl[id + 1] - s_tmpl[id - 1]);
        if (pr[k] > 0 && pr[k] < P - 1) gy = 0.5f * (s_tmpl[id + P] - s_tmpl[id - P]);
      }
      s_tmpl[kSlots + id] = gx;
      s_tmpl[2 * kSlots + id] = gy;
      G[0] = __fadd_rn(G[0], __fmul_rn(gx, gx));
      G[1] = __fadd_rn(G[1], __fmul_rn(gx, gy));
      G[2] = __fadd_rn(G[2], __fmul_rn(gy, gy));
    }
    cta_sum<3>(G, s_part, flip);
    if (tt == 0) {
      const float Gxx = G[0], Gxy = G[1], Gyy = G[2];
      const float det = __fsub_rn(__fmul_rn(Gxx, Gyy), __fmul_rn(Gxy, Gxy));
      const float d = __fsub_rn(Gxx, Gyy);
      const float disc =
          __fadd_rn(__fmul_rn(d, d), __fmul_rn(4.0f, __fmul_rn(Gxy, Gxy)));
      const bool good = det > 1e-6f;
      LevelInfo& li = s_info[lev];
      li.Gxx = Gxx;
      li.Gxy = Gxy;
      li.Gyy = Gyy;
      li.safe_det = good ? det : 1.0f;
      li.eig = 0.5f * __fsub_rn(__fadd_rn(Gxx, Gyy), __fsqrt_rn(disc));
      li.good = good;
    }
  }
  __syncthreads();

  // ---- phase B: the chain, coarse to fine ----
  float qx, qy;
  if (uv_guess != nullptr) {
    qx = uv_guess[2 * n];
    qy = uv_guess[2 * n + 1];
  } else {
    const float sc = 1.0f / static_cast<float>(1 << (L - 1));
    qx = u0 * sc;
    qy = v0 * sc;
  }
  int off[kPix];  // a pixel's offset inside the window block, in the slab
#pragma unroll
  for (int k = 0; k < kPix; ++k) off[k] = pr[k] * kSlabStride + pc[k];
  bool ok = false;
  for (int lev = L - 1; lev >= 0; --lev) {
    const int tmpl0 = lev * kLevelFloats;  // of this level in s_levels
    const int slab0 = tmpl0 + 3 * kSlots;
    const LevelInfo li = s_info[lev];
    const int H = li.H;
    const int W = li.W;
    const bool good = li.good != 0;
    float tv[kPix], gx[kPix], gy[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int id = tt * kPix + k;
      tv[k] = id < P * P ? s_levels[tmpl0 + id] : 0.0f;
      gx[k] = s_levels[tmpl0 + kSlots + id];
      gy[k] = s_levels[tmpl0 + 2 * kSlots + id];
    }
    const int n_it = lev == 0 ? iters : min(iters, coarse_iters);
    const int sw = min(S, W);
    const int sh = min(S, H);
    int sx0 = li.sx0, sy0 = li.sy0;
    bool ok_iter = li.in_bounds != 0;
    for (int it = 0; it < n_it; ++it) {
      const Window w = window_at(qx, qy, half, P, H, W);
      const bool inside =
          w.x >= sx0 && w.x + P + 1 <= sx0 + sw && w.y >= sy0 && w.y + P + 1 <= sy0 + sh;
      if (!inside) {  // uniform over the CTA: qx, qy are bitwise equal in its threads
        sx0 = slab_origin(w.x, sw, W);
        sy0 = slab_origin(w.y, sh, H);
        __syncthreads();  // the previous iteration's reads are done
        stage_slab(s_levels + slab0, pyr.next[lev], W, sx0, sy0, sw, sh, S, tt);
        __syncthreads();
      }
      const int base = slab0 + (w.y - sy0) * kSlabStride + (w.x - sx0);
      float b[2] = {0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const float err =
            __fsub_rn(bilinear(s_levels, base + off[k], kSlabStride, w.fx, w.fy), tv[k]);
        b[0] = __fadd_rn(b[0], __fmul_rn(gx[k], err));
        b[1] = __fadd_rn(b[1], __fmul_rn(gy[k], err));
      }
      cta_sum<2>(b, s_part, flip);
      const float dx =
          __fdiv_rn(__fsub_rn(__fmul_rn(li.Gyy, b[0]), __fmul_rn(li.Gxy, b[1])), li.safe_det);
      const float dy =
          __fdiv_rn(__fsub_rn(__fmul_rn(li.Gxx, b[1]), __fmul_rn(li.Gxy, b[0])), li.safe_det);
      if (good && w.in_bounds) {
        qx = __fsub_rn(qx, dx);
        qy = __fsub_rn(qy, dy);
      }
      ok_iter = ok_iter && w.in_bounds;
    }
    if (lev == 0) {
      ok = (li.in_bounds != 0) && ok_iter && good && li.eig >= min_eig;
    } else {
      qx = __fmul_rn(qx, 2.0f);
      qy = __fmul_rn(qy, 2.0f);
    }
  }
  if (tt == 0) {
    uv_out[2 * n] = qx;
    uv_out[2 * n + 1] = qy;
    ok_out[n] = (valid[n] != 0) && ok;
  }
}

template <int HALF>
int launch_half(const Pyramid& pyr, const float* uv_prev, const float* uv_guess,
                const unsigned char* valid, float* uv_out, unsigned char* ok_out, int N, int half,
                int iters, int coarse_iters, float min_eig, cudaStream_t stream) {
  // 8 levels need more than the 48 KB a kernel gets without asking
  static const cudaError_t allowed =
      cudaFuncSetAttribute(lk_kernel<HALF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxLevels * kLevelFloats * static_cast<int>(sizeof(float)));
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const size_t smem = pyr.levels * kLevelFloats * sizeof(float);
  lk_kernel<HALF><<<N, kThreads, smem, stream>>>(pyr, uv_prev, uv_guess, valid, uv_out, ok_out,
                                                 half, iters, coarse_iters, min_eig);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Pyramid& pyr, const float* uv_prev, const float* uv_guess,
           const unsigned char* valid, float* uv_out, unsigned char* ok_out, int N, int half,
           int iters, int coarse_iters, float min_eig, cudaStream_t stream) {
  if (pyr.levels < 1 || pyr.levels > kMaxLevels || half < 0 || half > 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  if (half == 7) {
    return launch_half<7>(pyr, uv_prev, uv_guess, valid, uv_out, ok_out, N, half, iters,
                          coarse_iters, min_eig, stream);
  }
  return launch_half<0>(pyr, uv_prev, uv_guess, valid, uv_out, ok_out, N, half, iters,
                        coarse_iters, min_eig, stream);
}

}  // namespace

// The whole pyramid in one launch. pyr_prev/pyr_next: host arrays of
// `levels` device pointers to (Hs[l], Ws[l]) float32 images, level 0
// first, every side >= 2*half+2; uv_prev/uv_out: (N, 2) float32;
// valid/ok_out: (N,) bytes (torch.bool); all contiguous on the device;
// levels <= 8, half <= 7. Level 0 runs `iters` iterations and gates on
// `min_eig`, the levels above run min(iters, coarse_iters) and gate on
// nothing. Launches on `stream`, returns cudaGetLastError().
extern "C" int uvio_lk_track(const float* const* pyr_prev, const float* const* pyr_next,
                             const int* Hs, const int* Ws, int levels, const float* uv_prev,
                             const unsigned char* valid, float* uv_out, unsigned char* ok_out,
                             int N, int half, int iters, int coarse_iters, float min_eig,
                             cudaStream_t stream) {
  if (levels < 1 || levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Pyramid pyr;
  pyr.levels = levels;
  for (int l = 0; l < levels; ++l) {
    pyr.prev[l] = pyr_prev[l];
    pyr.next[l] = pyr_next[l];
    pyr.H[l] = Hs[l];
    pyr.W[l] = Ws[l];
  }
  return launch(pyr, uv_prev, nullptr, valid, uv_out, ok_out, N, half, iters, coarse_iters,
                min_eig, stream);
}

// One level from the caller's guess: the same kernel on a one-level
// pyramid. img_prev/img_next: (H, W) float32; uv_guess: (N, 2) float32;
// the rest as above.
extern "C" int uvio_lk_level(const float* img_prev, const float* img_next, int H, int W,
                             const float* uv_prev, const float* uv_guess,
                             const unsigned char* valid, float* uv_out, unsigned char* ok_out,
                             int N, int half, int iters, float min_eig, cudaStream_t stream) {
  Pyramid pyr;
  pyr.levels = 1;
  pyr.prev[0] = img_prev;
  pyr.next[0] = img_next;
  pyr.H[0] = H;
  pyr.W[0] = W;
  return launch(pyr, uv_prev, uv_guess, valid, uv_out, ok_out, N, half, iters, iters, min_eig,
                stream);
}
