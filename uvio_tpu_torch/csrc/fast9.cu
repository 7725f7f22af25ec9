// FAST-9 corner score map for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fast_score_pallas` / `_fast_kernel`
// in uvio_tpu/frontend/pallas_kernels.py. Contract: `klt.fast_score`
// (uvio_tpu/frontend/klt.py:72-112). For every pixel, the 16 pixels of
// the radius-3 Bresenham ring (`klt._CIRCLE` order) are compared with
// the centre +- thresh; the pixel is a corner when 9 or more contiguous
// ring pixels (circularly) are all brighter or all darker; its score is
// the sum of |d| - thresh over the ring pixels past the threshold,
// accumulated in ring order in float32; the 3-px borders are 0.
//
// Bound: bytes. The image is read once and the score written once
// (2.89 MB at 752x480, under a microsecond of the card's memory rate),
// against about 12 operations a pixel for almost every pixel. One frame
// fills the card once, so the time is a launch plus one load -> compute
// -> store pass; the design makes that pass short:
//   * a thread owns 4 consecutive pixels: the tile is staged with
//     16-byte loads and the scores leave with 16-byte stores,
//     neighbouring threads on neighbouring addresses. A 128 x kRows tile
//     stages (128+8) x (kRows+6) floats, the x halo widened from 3 to 4
//     so every load is aligned: 1.86x the outputs at 8 rows (the halo
//     rows come out of L2), against 2.08x in 4-byte loads for the 32x8
//     tile this replaces. 16 rows stage 1.46x but were slower on an H100
//     (PERF.md, section 6): more, smaller CTAs hide the one load better;
//   * the compass pretest: any 9 contiguous ring positions hold at least
//     2 of the positions 0, 4, 8, 12, so a pixel with fewer than 2 of
//     those four brighter and fewer than 2 darker scores 0. The four
//     come out of 5 aligned 16-byte shared loads per thread; only the
//     survivors read and sum the 16-pixel ring, in ring order, so the
//     score is bitwise the plain version's;
//   * the rings are what costs (on an H100 a frame of zeros takes 2.4 us,
//     a random one, where almost every pixel survives, 6.7; PERF.md,
//     section 6): a warp, which owns one 128-pixel row of the tile,
//     compacts its survivors with ballots into a list and gives each
//     lane one survivor's ring, so a row with up to 32 survivors costs
//     one ring pass and not four; the arc test is 4 shift-and-AND steps
//     on the duplicated 16-bit mask; the ring offsets are immediates;
//   * borders are written as 0 by the same launch; the output is
//     written exactly once;
//   * widths that are not a multiple of 4 (or unaligned pointers) take
//     the same kernel with scalar loads and stores.
// One CTA per tile: at 752x480 the 360 CTAs of 256 threads are all
// resident at once (132 SMs x 8), so a persistent grid has nothing left
// to overlap.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kR = 3;              // ring radius
constexpr int kPX = 4;             // pixels a thread owns
constexpr int kBX = 32;            // threads along x
constexpr int kRows = 8;           // threads (and output rows) along y
constexpr int kTileW = kBX * kPX;  // 128 output columns
constexpr int kHaloX = 4;          // staged columns left and right of the tile
constexpr int kSW = kTileW + 2 * kHaloX;  // staged width, a multiple of 4
constexpr int kSH = kRows + 2 * kR;       // staged height
constexpr int kThreads = kBX * kRows;

// Whether 9 or more circularly contiguous bits of a 16-bit ring mask are
// set: the mask twice in 32 bits, then runs of 2, 4, 8 and 9 by shifts.
__device__ __forceinline__ bool has_arc9(unsigned int m) {
  const unsigned int x = m | (m << 16);
  const unsigned int r2 = x & (x >> 1);
  const unsigned int r4 = r2 & (r2 >> 2);
  const unsigned int r8 = r4 & (r4 >> 4);
  return (r8 & (x >> 8)) != 0u;
}

// Score of the pixel at p (row stride kSW, centre value c).
__device__ __forceinline__ float ring_score(const float* p, float c, float thresh) {
  // (dy, dx) of the ring, in `klt._CIRCLE` order
  constexpr int c_ring_dy[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int c_ring_dx[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
  unsigned int mb = 0u, md = 0u;
  float mag = 0.0f;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const float d = p[c_ring_dy[s] * kSW + c_ring_dx[s]] - c;
    const bool b = d > thresh;
    const bool dk = d < -thresh;
    mb |= static_cast<unsigned int>(b) << s;
    md |= static_cast<unsigned int>(dk) << s;
    mag += (b || dk) ? (fabsf(d) - thresh) : 0.0f;
  }
  return (has_arc9(mb) || has_arc9(md)) ? mag : 0.0f;
}

// VEC: W % 4 == 0 and both pointers 16-byte aligned. A warp is one row
// of the tile: 32 threads x 4 pixels.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
fast9_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W, float thresh) {
  __shared__ __align__(16) float tile[kSH][kSW];
  __shared__ __align__(16) float s_score[kRows][kTileW];
  __shared__ unsigned char s_list[kRows][kTileW];  // a row's survivors, as tile columns
  const int x0 = blockIdx.x * kTileW;  // first output column of the tile
  const int y0 = blockIdx.y * kRows;
  const int lane = threadIdx.x;
  const int row = threadIdx.y;
  const int tid = row * kBX + lane;

  // ---- stage the tile and its halo; pixels outside the image read 0 ----
  if (VEC) {
    constexpr int kSW4 = kSW / 4;
    for (int i = tid; i < kSH * kSW4; i += kThreads) {
      const int ty = i / kSW4;
      const int tx = (i % kSW4) * 4;
      const int gy = y0 + ty - kR;
      const int gx = x0 + tx - kHaloX;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = *reinterpret_cast<const float4*>(img + static_cast<size_t>(gy) * W + gx);
      }
      *reinterpret_cast<float4*>(&tile[ty][tx]) = v;
    }
  } else {
    for (int i = tid; i < kSH * kSW; i += kThreads) {
      const int ty = i / kSW;
      const int tx = i % kSW;
      const int gy = y0 + ty - kR;
      const int gx = x0 + tx - kHaloX;
      tile[ty][tx] =
          (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[static_cast<size_t>(gy) * W + gx] : 0.0f;
    }
  }
  *reinterpret_cast<float4*>(&s_score[row][lane * kPX]) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  const int x = x0 + lane * kPX;  // first of this thread's 4 pixels
  const int y = y0 + row;
  const int cy = row + kR;
  const int cx = lane * kPX + kHaloX;

  // ---- compass pretest on positions 0 (E), 4 (S), 8 (W), 12 (N) ----
  const float4 mid = *reinterpret_cast<const float4*>(&tile[cy][cx]);
  const float4 lft = *reinterpret_cast<const float4*>(&tile[cy][cx - 4]);
  const float4 rgt = *reinterpret_cast<const float4*>(&tile[cy][cx + 4]);
  const float4 dwn = *reinterpret_cast<const float4*>(&tile[cy + kR][cx]);
  const float4 up = *reinterpret_cast<const float4*>(&tile[cy - kR][cx]);
  const float c[kPX] = {mid.x, mid.y, mid.z, mid.w};
  const float east[kPX] = {mid.w, rgt.x, rgt.y, rgt.z};  // x + 3
  const float west[kPX] = {lft.y, lft.z, lft.w, mid.x};  // x - 3
  const float south[kPX] = {dwn.x, dwn.y, dwn.z, dwn.w};
  const float north[kPX] = {up.x, up.y, up.z, up.w};
  const bool row_inside = y >= kR && y < H - kR;

  // ---- the row's survivors, compacted: each is one lane's ring ----
  int total = 0;
#pragma unroll
  for (int j = 0; j < kPX; ++j) {
    const float de = east[j] - c[j];
    const float ds = south[j] - c[j];
    const float dw = west[j] - c[j];
    const float dn = north[j] - c[j];
    const int brighter = (de > thresh) + (ds > thresh) + (dw > thresh) + (dn > thresh);
    const int darker = (de < -thresh) + (ds < -thresh) + (dw < -thresh) + (dn < -thresh);
    const bool survives = row_inside && x + j >= kR && x + j < W - kR &&
                          (brighter >= 2 || darker >= 2);
    const unsigned int votes = __ballot_sync(0xffffffffu, survives);
    if (survives) {
      s_list[row][total + __popc(votes & ((1u << lane) - 1u))] =
          static_cast<unsigned char>(lane * kPX + j);
    }
    total += __popc(votes);
  }
  __syncwarp();
  for (int k = lane; k < total; k += 32) {
    const int px = s_list[row][k];
    const float* p = &tile[cy][kHaloX + px];
    s_score[row][px] = ring_score(p, *p, thresh);
  }
  __syncwarp();

  if (x >= W || y >= H) return;
  const float4 score = *reinterpret_cast<const float4*>(&s_score[row][lane * kPX]);
  float* dst = out + static_cast<size_t>(y) * W + x;
  if (VEC) {
    *reinterpret_cast<float4*>(dst) = score;
  } else {
    const float sc[kPX] = {score.x, score.y, score.z, score.w};
#pragma unroll
    for (int j = 0; j < kPX; ++j) {
      if (x + j < W) dst[j] = sc[j];
    }
  }
}

}  // namespace

// img and out: (H, W) float32, contiguous, on the device. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int uvio_fast9(const float* img, float* out, int H, int W, float thresh,
                          cudaStream_t stream) {
  if (H <= 0 || W <= 0) return 0;
  const dim3 block(kBX, kRows);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kRows - 1) / kRows);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    fast9_kernel<true><<<grid, block, 0, stream>>>(img, out, H, W, thresh);
  } else {
    fast9_kernel<false><<<grid, block, 0, stream>>>(img, out, H, W, thresh);
  }
  return static_cast<int>(cudaGetLastError());
}
