// Small dense factorizations in shared memory that the filter kernels
// (`slam_init.cu`, `msckf_update.cu`) share: a feature's three Householder
// reflections of H_f, a Cholesky factor and a forward substitution, each by
// one warp.

#pragma once

#include <cmath>

#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LAPACK's geqr2 on the M x 3 matrix hh ([k][j], row-major) by one warp, the
// lanes over the rows: R above the diagonal, v below it (v_j = 1 implied),
// tau[j] the reflections' factors.
template <typename T>
__device__ void householder3_warp(T* hh, int M, T* tau) {
  const int lane = threadIdx.x % 32;
  for (int j = 0; j < 3; ++j) {
    T part = T(0);
    for (int k = j + 1 + lane; k < M; k += 32) part += hh[k * 3 + j] * hh[k * 3 + j];
    const T xn2 = warp_sum(part), alpha = hh[j * 3 + j];
    T t = T(0), beta = alpha, scale = T(1);
    if (xn2 != T(0)) {
      beta = -copysign(sqrt(alpha * alpha + xn2), alpha);
      t = (beta - alpha) / beta;
      scale = T(1) / (alpha - beta);
    }
    __syncwarp();
    for (int k = j + 1 + lane; k < M; k += 32) hh[k * 3 + j] *= scale;
    if (lane == 0) {
      hh[j * 3 + j] = beta;
      tau[j] = t;
    }
    __syncwarp();
    for (int c = j + 1; c < 3; ++c) {
      T dot = T(0);
      for (int k = j + 1 + lane; k < M; k += 32) dot += hh[k * 3 + j] * hh[k * 3 + c];
      const T w = (hh[j * 3 + c] + warp_sum(dot)) * t;
      __syncwarp();
      if (lane == 0) hh[j * 3 + c] -= w;
      for (int k = j + 1 + lane; k < M; k += 32) hh[k * 3 + c] -= w * hh[k * 3 + j];
      __syncwarp();
    }
  }
}

// y (M values `ld` apart) through the three reflections that
// `householder3_warp` left in hh and tau
template <typename T>
__device__ __forceinline__ void reflect3(T* y, int ld, const T* hh, const T* tau, int M) {
  for (int j = 0; j < 3; ++j) {
    T t = y[j * ld];
    for (int k = j + 1; k < M; ++k) t += hh[k * 3 + j] * y[k * ld];
    t *= tau[j];
    y[j * ld] -= t;
    for (int k = j + 1; k < M; ++k) y[k * ld] -= t * hh[k * 3 + j];
  }
}

// In-place lower Cholesky factor of the n x n matrix A (row-major, leading
// dimension ld, lower triangle read) by one warp; a pivot that is not
// positive (or NaN) fills the factor with NaN, as the plain version's
// failed factorization does.
template <typename T>
__device__ void chol_warp(T* A, int n, int ld) {
  const int lane = threadIdx.x % 32;
  bool ok = true;
  for (int j = 0; j < n; ++j) {
    const T d = A[j * ld + j];
    ok = ok && d > T(0);
    const T piv = sqrt(d);
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) A[i * ld + j] /= piv;
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) {
      const T lij = A[i * ld + j];
      for (int k = j + 1; k <= i; ++k) A[i * ld + k] -= lij * A[k * ld + j];
    }
    if (lane == 0) A[j * ld + j] = piv;
    __syncwarp();
  }
  if (!ok)
    for (int e = lane; e < n * ld; e += 32) A[e] = T(NAN);
  __syncwarp();
}

// |L^-1 b|^2 for the lower factor L (n x n, leading dimension ld) by one
// warp, b overwritten; the sum reaches lane 0
template <typename T>
__device__ T forward_norm2(const T* L, int n, int ld, T* b) {
  const int lane = threadIdx.x % 32;
  T sum = T(0);
  for (int j = 0; j < n; ++j) {
    const T y = b[j] / L[j * ld + j];
    sum += y * y;
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) b[i] -= L[i * ld + j] * y;
    __syncwarp();
  }
  return sum;
}

}  // namespace
