// The state's mean as the filter kernels (`uwb_update.cu`, `slam_init.cu`)
// take it: a table of mean blocks (`filter/ekf.py` `inject_table`, encoded
// by `table_ints`) staged in shared memory, corrected there (quaternion rows
// by the error quaternion's product, the rest added, masked rows left
// alone) and written back. Every helper strides by kThreads, one thread a
// value or a block row.

#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBlocks = 24;  // mean blocks in the table
constexpr int kMaxSmem = 232448;

struct Block {
  const void* in;
  void* out;
  int quat, rows, width, err_off, err_stride, mask;
  int off, row0;  // its first value in the staged mean, its first row among all blocks' rows
};

struct Table {  // as a kernel's parameters hold it
  const bool* masks[3];  // clones_valid, slam_valid, anchors_valid
  int nblocks;
  int mean_len, rows;  // values and rows of all blocks together
  Block blocks[kMaxBlocks];
};

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ double ldcg(const double* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ int ldcg(const int* p) { return __ldcg(p); }

// the block holding row `row` among all blocks' rows
__device__ __forceinline__ int block_of_row(const Block* blocks, int row) {
  int k = 0;
  while (row >= blocks[k].row0 + blocks[k].rows) ++k;
  return k;
}

// q <- quat_norm(dq (x) q), dq = quat_norm([dth / 2, 1]) (JPL, w last, w >= 0)
template <typename T>
__device__ void quat_inject(T* q, T dx, T dy, T dz) {
  T e[4] = {T(0.5) * dx, T(0.5) * dy, T(0.5) * dz, T(1)};
  T n = sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2] + e[3] * e[3]);
  for (int i = 0; i < 4; ++i) e[i] /= n;
  if (e[3] < T(0))
    for (int i = 0; i < 4; ++i) e[i] = -e[i];
  const T pv[3] = {q[0], q[1], q[2]}, pw = q[3];
  T r[4];
  r[0] = e[3] * pv[0] + pw * e[0] - (e[1] * pv[2] - e[2] * pv[1]);
  r[1] = e[3] * pv[1] + pw * e[1] - (e[2] * pv[0] - e[0] * pv[2]);
  r[2] = e[3] * pv[2] + pw * e[2] - (e[0] * pv[1] - e[1] * pv[0]);
  r[3] = e[3] * pw - (e[0] * pv[0] + e[1] * pv[1] + e[2] * pv[2]);
  n = sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + r[3] * r[3]);
  const T s = r[3] / n < T(0) ? -n : n;
  for (int i = 0; i < 4; ++i) q[i] = r[i] / s;
}

// dst[at(i)] = src[at(i)] for i < n, kUnroll loads in flight a thread
template <typename T, typename At>
__device__ __forceinline__ void copy_values(T* dst, const T* src, int n, At at) {
  constexpr int kUnroll = 8;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) v[u] = src[at(i)];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) dst[at(i)] = v[u];
    }
  }
}

// s_blocks <- the parameters' table, one thread a block (no barrier)
__device__ __forceinline__ void load_table(Block* s_blocks, const Table& t) {
#pragma unroll
  for (int k = 0; k < kMaxBlocks; ++k)  // constant indices into the parameters
    if (static_cast<int>(threadIdx.x) == k && k < t.nblocks) s_blocks[k] = t.blocks[k];
}

// sequence `seq`'s mean blocks into `mean`, each block row's mask into `keep` (no barrier)
template <typename T>
__device__ __forceinline__ void stage_mean(T* mean, unsigned char* keep, const Block* s_blocks, const Table& t,
                                           int seq) {
  for (int i = threadIdx.x; i < t.mean_len; i += kThreads) {
    int k = 0;
    while (i >= s_blocks[k].off + s_blocks[k].rows * s_blocks[k].width) ++k;
    const Block& blk = s_blocks[k];
    mean[i] = static_cast<const T*>(blk.in)[static_cast<size_t>(seq) * blk.rows * blk.width + i - blk.off];
  }
  for (int row = threadIdx.x; row < t.rows; row += kThreads) {
    const Block& blk = s_blocks[block_of_row(s_blocks, row)];
    keep[row] = blk.mask < 0 || t.masks[blk.mask][static_cast<size_t>(seq) * blk.rows + row - blk.row0];
  }
}

// Injects dx(e), the correction of error coordinate e, into the staged mean's
// `rows` block rows, one thread a row; `dx` is each kernel's own expression and
// rounding. A macro, not a function: as a function (forced inline or not) it
// made ptxas spill 40 bytes of uwb_update_kernel<double, false>, which the
// loop written out in the kernel does not.
#define INJECT_ROWS(mean, keep, s_blocks, rows, dx)                                  \
  do {                                                                               \
    const auto dx_ = (dx);                                                           \
    for (int row_ = threadIdx.x; row_ < (rows); row_ += kThreads) {                  \
      if (!(keep)[row_]) continue;                                                   \
      const Block& blk_ = (s_blocks)[block_of_row((s_blocks), row_)];                \
      auto* x_ = (mean) + blk_.off + (row_ - blk_.row0) * blk_.width;                \
      const int e_ = blk_.err_off + (row_ - blk_.row0) * blk_.err_stride;            \
      if (blk_.quat) {                                                               \
        quat_inject(x_, dx_(e_), dx_(e_ + 1), dx_(e_ + 2));                          \
      } else {                                                                       \
        for (int j_ = 0; j_ < blk_.width; ++j_) x_[j_] += dx_(e_ + j_);              \
      }                                                                              \
    }                                                                                \
  } while (0)

// the staged mean into every block's output of sequence `seq`
template <typename T>
__device__ __forceinline__ void store_mean(const T* mean, const Block* s_blocks, int mean_len, int seq) {
  for (int i = threadIdx.x; i < mean_len; i += kThreads) {
    int k = 0;
    while (i >= s_blocks[k].off + s_blocks[k].rows * s_blocks[k].width) ++k;
    const Block& blk = s_blocks[k];
    static_cast<T*>(blk.out)[static_cast<size_t>(seq) * blk.rows * blk.width + i - blk.off] = mean[i];
  }
}

// `t` from the table's ints (nblocks, then per block quat, rows, width,
// err_off, err_stride, mask: -1, or 0..2 into the masks), the masks and each
// block's input and output (`pairs`; either may be null); returns
// cudaErrorInvalidValue for a table the kernels do not take.
inline int parse_table(const int* ints, const int64_t* masks, const int64_t* pairs, Table& t) {
  t = Table{};
  t.nblocks = ints[0];
  if (t.nblocks < 1 || t.nblocks > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  if (masks)
    for (int i = 0; i < 3; ++i) t.masks[i] = reinterpret_cast<const bool*>(masks[i]);
  for (int k = 0; k < t.nblocks; ++k) {
    const int* b = ints + 1 + 6 * k;
    if (b[1] < 1 || b[2] < 1 || b[5] < -1 || b[5] > 2) return static_cast<int>(cudaErrorInvalidValue);
    t.blocks[k] = Block{pairs ? reinterpret_cast<const void*>(pairs[2 * k]) : nullptr,
                        pairs ? reinterpret_cast<void*>(pairs[2 * k + 1]) : nullptr,
                        b[0], b[1], b[2], b[3], b[4], b[5], t.mean_len, t.rows};
    t.mean_len += b[1] * b[2];
    t.rows += b[1];
  }
  return 0;
}

// Opts `kernel` in to the block's whole shared memory less its static
// part, once, and leaves in `max_dynamic` the dynamic bytes it may take.
// The first call comes before any capture: a graph capture of a kernel
// follows an eager run of the same step.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int& max_dynamic) {
  if (max_dynamic > 0) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  const int bytes = kMaxSmem - static_cast<int>(attr.sharedSizeBytes);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) max_dynamic = bytes;
  return e;
}

}  // namespace
