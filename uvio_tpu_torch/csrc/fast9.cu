// FAST-9 corner score map for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fast_score_pallas` / `_fast_kernel`
// in uvio_tpu/frontend/pallas_kernels.py. Contract: `klt.fast_score`
// (uvio_tpu/frontend/klt.py:72-112). For every pixel, the 16 pixels of
// the radius-3 Bresenham ring (`klt._CIRCLE` order) are compared with
// the centre +- thresh and packed as bits; the pixel is a corner when 9
// or more contiguous ring bits (circularly) are all brighter or all
// darker; its score is the sum of |d| - thresh over the ring pixels past
// the threshold, accumulated in ring order; the 3-px borders are 0.
//
// Bound: memory and launch. At 752x480 the kernel reads the image once
// and writes the score once (1.44 MB each way) and does ~100 flops per
// pixel, far below the card's ratio of flops to bytes. Design: one
// thread per pixel; a 32x8 block stages its tile plus a 3-px halo in
// shared memory, so each image byte is read from device memory about
// once (the halo adds ~1.7x on an 8-row tile, served by L2); the ring
// offsets sit in constant memory; the arc test duplicates the 16-bit
// masks into 32 bits and checks the 16 windows of 9 bits.

#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kR = 3;
constexpr int kTW = kBX + 2 * kR;
constexpr int kTH = kBY + 2 * kR;

// (dy, dx) of the ring, in `klt._CIRCLE` order
__constant__ int c_ring_dy[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int c_ring_dx[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};

__global__ void fast9_kernel(const float* __restrict__ img, float* __restrict__ out,
                             int H, int W, float thresh) {
  __shared__ float tile[kTH][kTW];
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  for (int i = threadIdx.y * kBX + threadIdx.x; i < kTH * kTW; i += kBX * kBY) {
    const int ty = i / kTW;
    const int tx = i % kTW;
    const int gy = y0 + ty - kR;
    const int gx = x0 + tx - kR;
    tile[ty][tx] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[gy * W + gx] : 0.0f;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  float score = 0.0f;
  if (x >= kR && x < W - kR && y >= kR && y < H - kR) {
    const int cy = threadIdx.y + kR;
    const int cx = threadIdx.x + kR;
    const float c = tile[cy][cx];
    unsigned int mb = 0u, md = 0u;
    float mag = 0.0f;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const float d = tile[cy + c_ring_dy[s]][cx + c_ring_dx[s]] - c;
      const bool b = d > thresh;
      const bool dk = d < -thresh;
      mb |= static_cast<unsigned int>(b) << s;
      md |= static_cast<unsigned int>(dk) << s;
      mag += (b || dk) ? (fabsf(d) - thresh) : 0.0f;
    }
    mb |= mb << 16;
    md |= md << 16;
    bool corner = false;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      corner |= ((mb >> s) & 0x1FFu) == 0x1FFu;
      corner |= ((md >> s) & 0x1FFu) == 0x1FFu;
    }
    score = corner ? mag : 0.0f;
  }
  out[y * W + x] = score;
}

}  // namespace

// img and out: (H, W) float32, contiguous, on the device. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int uvio_fast9(const float* img, float* out, int H, int W, float thresh,
                          cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY);
  fast9_kernel<<<grid, block, 0, stream>>>(img, out, H, W, thresh);
  return static_cast<int>(cudaGetLastError());
}
