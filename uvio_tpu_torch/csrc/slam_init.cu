// The SLAM delayed initialization of one frame's candidates, in one launch.
//
// Replaces no TPU kernel: `uvio_tpu/update/slam.py` `slam_delayed_init` is
// plain JAX, and the port's plain version (`update/slam.py`
// `slam_delayed_init_ref`) runs its candidates in a Python loop, each on
// the covariance the previous one left: a Gram matrix, two Cholesky
// factorizations, a 3x3 QR, the block's writes, a general `ekf_update`
// and a select of every state field, some 140 small launches a candidate
// and about 1,400 nodes of the step's CUDA graph for 8 candidates. This
// kernel does the same arithmetic in one launch.
//
// Contract: `slam_delayed_init_ref` from its packed systems on. For
// candidate i = 0..Fc-1 in order, on the state the previous accepted one
// left:
//   * split: three Householder reflections of H_f (M x 3), applied to
//     [H_x | r], give the 3-row init system (R = Hf_tri upper triangular,
//     H_init, r_init) and M-3 update rows; the plain version's complete QR
//     differs from it only by rounding (and its orthonormal completion,
//     to which every quantity below is invariant);
//   * gate: gamma = r_up^T (H_up P H_up^T + s2 I)^-1 r_up (NaN where the
//     Cholesky factor fails), accepted = active & gamma < thresh (a NaN
//     rejects) & |R00 R11 R22| > 1e-9;
//   * on accept: the invertible block at the slot's offset (cross terms
//     -P H_init^T R^-T, block R^-1 (H_init P H_init^T + s2 I) R^-T, value
//     vals0 + R^-1 r_init), the slot's landmark fields, then the EKF update
//     with the update rows: K = P H^T S^-1, S = sym(H P H^T + s2 I),
//     P <- sym(P - K (P H^T)^T), dx = K r injected into every mean block
//     the layout has (quaternions by the error quaternion's product, rows
//     of invalid clones, landmarks and anchors left alone); under the
//     single-depth representation the slot's two bearing rows and columns
//     are zeroed;
//   * on reject nothing changes; chi2 and inited are written either way.
//
// Bound: bytes and latency. The covariance read and written once is
// 2 D^2 sizeof(T): 1,016,064 B for the EuRoC cell's float64 D = 252, 0.30 us
// at 3.35 TB/s; the arithmetic is ~26 MFLOP for 8 accepted candidates.
// The time is the launch and a chain of dependent phases, so the design
// keeps the chain short:
//   * one cluster of n = min(Fc, 8) blocks a sequence (a batch, a vmapped
//     step, takes one cluster each); the covariance is updated in place in
//     global memory, where L2 holds it, each block owning the rows
//     r = rank (mod n); the blocks meet at the cluster's hardware barrier
//     and read what others wrote past L1 (`ld.global.cg`);
//   * a candidate's H_x is zero outside the columns its observations touch
//     (clone poses and calibration, not the IMU or the landmarks): the
//     split lists each candidate's live columns, and every product runs
//     over them only, which changes no sum but for exact zeros. Shared
//     memory holds H^T and a warp's row of P on at most `live_cap` of them,
//     the width of the camera calibration and clone columns (87 in the
//     EuRoC cell, 101 for its stereo layout), not D; a candidate with more
//     has a non-finite reflection (zero columns stay zero through finite
//     ones) that leaves its update rows NaN, and is rejected with chi2 NaN
//     as its gate would;
//   * the gates are speculative: each block gates its own candidates on
//     the current covariance at once, and the first accepted one is
//     applied; a rejected candidate changes nothing, so those before it
//     are final, and only those after it are gated again. A frame with no
//     accepted candidate is one round;
//   * the small systems (M x M Gram matrices, Cholesky factors, 3x3
//     inverses) are solved in shared memory by one warp, the same in every
//     block, so no block waits to be told; the leader (rank 0) keeps the
//     mean in shared memory and writes every output.

#include <cooperative_groups.h>

#include "mean_table.cuh"
#include "small_linalg.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;    // M = 2 K C, a candidate's stacked rows
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxCands = 64;
constexpr int kChunk = 8;  // rows of K and P H^T staged at a time in the covariance update
constexpr int kPer = 16;   // covariance pairs a thread updates at a time

struct Args {
  const void* cov_in;
  void* cov_out;
  const void* hx;   // (Fc, M, D) packed H_x
  const void* hf;   // (Fc, M, 3) packed H_f
  const void* res;  // (Fc, M)
  const double* thresh;
  const bool* active;
  const int64_t* slots;
  const int64_t* ids;
  const void* vals0;  // (Fc, 3)
  const int64_t* anchor_slot;
  bool* slam_valid_out;
  const void* fej_in;
  void* fej_out;
  const int64_t* meta_in[3];  // slam_id, slam_anchor_slot, slam_anchor_cam
  int64_t* meta_out[3];
  bool* inited;
  void* chi2;
  unsigned char* work;
  int work_bytes;  // a sequence's share of `work`
  int dim, fc, m_rows, live_cap, slam_off, max_slam, freeze, cluster, slam_block;
  double sigma2;
  Table table;
};

// A sequence's workspace, in values of T, then ints: the transformed rows
// (Fc, M, D) and residuals (Fc, M), R (Fc, 3, 3), gamma (Fc), the Gram
// matrices (Fc, M, M), the cross terms (D, 3), P H^T (M, D) and K (M, D)
// of the update, dx (D); then each candidate's live count and columns
// (Fc, D + 1) and gate (Fc).
struct Work {
  size_t hxq, rq, rf, gam, sfull, cross, pht, kt, dx, values;
};

__host__ __device__ inline Work work_layout(int D, int Fc, int M) {
  Work w{};
  size_t o = 0;
  w.hxq = o, o += static_cast<size_t>(Fc) * M * D;
  w.rq = o, o += static_cast<size_t>(Fc) * M;
  w.rf = o, o += static_cast<size_t>(Fc) * 9;
  w.gam = o, o += Fc;
  w.sfull = o, o += static_cast<size_t>(Fc) * M * M;
  w.cross = o, o += static_cast<size_t>(D) * 3;
  w.pht = o, o += static_cast<size_t>(M) * D;
  w.kt = o, o += static_cast<size_t>(M) * D;
  w.dx = o, o += D;
  w.values = o;
  return w;
}

// bytes of a sequence's workspace, a multiple of 16
template <typename T>
size_t work_bytes(int D, int Fc, int M) {
  const size_t b = work_layout(D, Fc, M).values * sizeof(T) + static_cast<size_t>(Fc) * (D + 2) * sizeof(int);
  return (b + 15) / 16 * 16;
}

// Values of the block's scratch buffer: the gate's P H^T on the live rows
// (live_cap x M), the update's P H^T on the live rows (live_cap x (M - 3))
// or on a stretch of this block's rows, or kChunk rows of K and of P H^T
// (2 kChunk x D).
__host__ __device__ inline size_t buf_values(int D, int M, int cap) {
  const size_t live = static_cast<size_t>(cap) * M, chunk = static_cast<size_t>(2 * kChunk) * D;
  return live > chunk ? live : chunk;
}

// Dynamic shared memory, in values of T: H^T on the live columns
// (live_cap x M), the scratch buffer, the Gram matrix and a Cholesky factor
// (M x M each), two M-vectors, the Householder vectors (M x 3), a warp's
// row of the covariance on the live columns (live_cap a warp), the mean;
// then ints: the live columns (live_cap); then bytes: a flag a column (D)
// and a block row's mask (rows).
template <typename T>
size_t smem_bytes(const Args& a) {
  const size_t D = a.dim, M = a.m_rows, cap = a.live_cap;
  const size_t values =
      cap * M + buf_values(a.dim, a.m_rows, a.live_cap) + 2 * M * M + 2 * M + 3 * M + kWarps * cap + a.table.mean_len;
  return values * sizeof(T) + cap * sizeof(int) + D + a.table.rows;
}

// out[ri * ldo_r + b * ldo_b] = sum_k P[row(ri), cols[k]] hv[k * ldh + b0 + b]
// for ri < nr, b < nb, with row(ri) = rlist[ri], or r0 + ri * rstep without
// a list: one warp a row, which stages the row's values at `cols` in its
// buffer (`rows`, `ldw` >= nl values a warp), then each lane sums its
// outputs over k in order.
template <typename T>
__device__ void rows_times(const T* P, int D, const int* rlist, int r0, int rstep, int nr, const int* cols,
                           int nl, const T* hv, int ldh, int b0, int nb, T* out, int ldo_r, int ldo_b, T* rows,
                           int ldw) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  T* wrow = rows + warp * ldw;
  for (int ri = warp; ri < nr; ri += kWarps) {
    const int r = rlist ? rlist[ri] : r0 + ri * rstep;
    const T* prow = P + static_cast<size_t>(r) * D;
    __syncwarp();
#pragma unroll 4
    for (int k = lane; k < nl; k += 32) wrow[k] = ldcg(prow + cols[k]);
    __syncwarp();
    for (int b = lane; b < nb; b += 32) {
      const T* h = hv + b0 + b;
      T acc = T(0);
      for (int k = 0; k < nl; ++k) acc += wrow[k] * h[k * ldh];
      out[ri * ldo_r + b * ldo_b] = acc;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) slam_init_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Block s_blocks[kMaxBlocks];
  __shared__ T s_tau[3], s_hinv[9], s_pll[9], s_dxf[3];

  const int D = a.dim, Fc = a.fc, M = a.m_rows, m = M - 3, n = a.cluster, cap = a.live_cap;
  const int rank = blockIdx.x, seq = blockIdx.y, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool leader = rank == 0;
  const T s2 = static_cast<T>(a.sigma2);
  const int nr = (D - rank + n - 1) / n;  // this block's rows: rank, rank + n, ...

  T* hv = reinterpret_cast<T*>(smem);  // [k][b], leading dimension M
  T* buf = hv + static_cast<size_t>(cap) * M;
  const int bufcap = static_cast<int>(buf_values(D, M, cap));
  T* gram = buf + bufcap;
  T* lf = gram + M * M;
  T* vec = lf + M * M;
  T* hh = vec + 2 * M;  // the Householder vectors, [k][j]
  T* rowbuf = hh + 3 * M;
  T* mean = rowbuf + kWarps * cap;
  int* live = reinterpret_cast<int*>(mean + a.table.mean_len);
  unsigned char* flag = reinterpret_cast<unsigned char*>(live + cap);
  unsigned char* keep = flag + D;

  const size_t DD = static_cast<size_t>(D) * D;
  const T* cov_in = static_cast<const T*>(a.cov_in) + seq * DD;
  T* P = static_cast<T*>(a.cov_out) + seq * DD;
  const T* hx = static_cast<const T*>(a.hx) + static_cast<size_t>(seq) * Fc * M * D;
  const T* hf = static_cast<const T*>(a.hf) + static_cast<size_t>(seq) * Fc * M * 3;
  const T* res = static_cast<const T*>(a.res) + static_cast<size_t>(seq) * Fc * M;
  const double* thresh = a.thresh + seq * Fc;
  const bool* active = a.active + seq * Fc;
  const int64_t* slots = a.slots + seq * Fc;
  const int64_t* ids = a.ids + seq * Fc;
  const T* vals0 = static_cast<const T*>(a.vals0) + seq * Fc * 3;
  const int S = a.max_slam;
  bool* inited = a.inited + seq * Fc;
  T* chi2 = static_cast<T*>(a.chi2) + seq * Fc;

  unsigned char* wb = a.work + static_cast<size_t>(seq) * a.work_bytes;
  const Work w = work_layout(D, Fc, M);
  T* W = reinterpret_cast<T*>(wb);
  T* hxq = W + w.hxq;
  T* rq = W + w.rq;
  T* rf = W + w.rf;
  T* gam = W + w.gam;
  T* sfull = W + w.sfull;
  T* cross = W + w.cross;
  T* pht = W + w.pht;
  T* kt = W + w.kt;
  T* dxw = W + w.dx;
  int* w_live = reinterpret_cast<int*>(wb + w.values * sizeof(T));  // (Fc, D + 1)
  int* w_ok = w_live + static_cast<size_t>(Fc) * (D + 1);

  // ---- set-up: this block's rows of the covariance; the leader stages
  // the mean and the masks and copies the landmark fields ----
  load_table(s_blocks, a.table);
  copy_values(P, cov_in, nr * D, [&](int e) { return static_cast<size_t>(rank + (e / D) * n) * D + e % D; });
  __syncthreads();
  if (leader) {
    stage_mean(mean, keep, s_blocks, a.table, seq);
    for (int i = tid; i < 3 * S; i += kThreads)
      static_cast<T*>(a.fej_out)[seq * 3 * S + i] = static_cast<const T*>(a.fej_in)[seq * 3 * S + i];
    for (int i = tid; i < 3 * S; i += kThreads)
      a.meta_out[i / S][seq * S + i % S] = a.meta_in[i / S][seq * S + i % S];
  }

  // ---- the split of this block's candidates ----
  for (int i = rank; i < Fc; i += n) {
    const T* hfi = hf + static_cast<size_t>(i) * M * 3;
    const T* hxi = hx + static_cast<size_t>(i) * M * D;
    const T* ri = res + static_cast<size_t>(i) * M;
    for (int e = tid; e < 3 * M; e += kThreads) hh[e] = hfi[e];
    __syncthreads();
    if (warp == 0) {
      householder3_warp(hh, M, s_tau);
      if (lane < 9) rf[i * 9 + lane] = lane % 3 >= lane / 3 ? hh[lane] : T(0);
    }
    __syncthreads();
    // each column of [H_x | r] through the three reflections
    for (int col = tid; col <= D; col += kThreads) {
      T y[kMaxRows];
      for (int k = 0; k < M; ++k) y[k] = col < D ? hxi[static_cast<size_t>(k) * D + col] : ri[k];
      reflect3(y, 1, hh, s_tau, M);
      bool nz = false;
      for (int k = 0; k < M; ++k) {
        nz = nz || y[k] != T(0);  // a NaN is live too
        if (col < D)
          hxq[(static_cast<size_t>(i) * M + k) * D + col] = y[k];
        else
          rq[i * M + k] = y[k];
      }
      if (col < D) flag[col] = nz;
    }
    __syncthreads();
    if (warp == 0) {  // the live columns, in order
      int count = 0;
      int* list = w_live + static_cast<size_t>(i) * (D + 1);
      for (int c0 = 0; c0 < D; c0 += 32) {
        const int c = c0 + lane;
        const bool f = c < D && flag[c];
        const unsigned bal = __ballot_sync(0xffffffffu, f);
        if (f) list[1 + count + __popc(bal & ((1u << lane) - 1u))] = c;
        count += __popc(bal);
      }
      if (lane == 0) list[0] = count;
    }
    __syncthreads();
  }
  cluster.sync();

  // stages candidate i's live columns into `live` and its H^T on them
  // into `hv`; returns their count (and stages nothing past `cap`)
  auto stage = [&](int i) {
    const int* list = w_live + static_cast<size_t>(i) * (D + 1);
    const int nl = ldcg(list);
    if (nl > cap) return nl;
    for (int k = tid; k < nl; k += kThreads) live[k] = ldcg(list + 1 + k);
    __syncthreads();
    for (int e = tid; e < nl * M; e += kThreads) {
      const int b = e / nl, k = e % nl;
      hv[k * M + b] = ldcg(hxq + (static_cast<size_t>(i) * M + b) * D + live[k]);
    }
    __syncthreads();
    return nl;
  };

  int lo = 0;
  while (true) {
    // ---- gate this block's candidates from lo on the current covariance ----
    for (int i = rank; i < Fc; i += n) {
      if (i < lo) continue;
      const int nl = stage(i);
      if (nl > cap) {  // a non-finite reflection: NaN update rows
        if (tid == 0) {
          gam[i] = T(NAN);
          w_ok[i] = 0;
        }
        continue;
      }
      rows_times(P, D, live, 0, 0, nl, live, nl, hv, M, 0, M, buf, M, 1, rowbuf, cap);
      __syncthreads();
      for (int e = tid; e < M * M; e += kThreads) {
        const int r = e / M, c = e % M;
        T acc = T(0);
        for (int k = 0; k < nl; ++k) acc += hv[k * M + r] * buf[k * M + c];
        gram[e] = acc;
        sfull[static_cast<size_t>(i) * M * M + e] = acc;
      }
      __syncthreads();
      if (warp == 0) {
        for (int e = lane; e < m * m; e += 32) {
          const int r = e / m, c = e % m;
          lf[e] = gram[(3 + r) * M + 3 + c] + (r == c ? s2 : T(0));
        }
        for (int k = lane; k < m; k += 32) vec[k] = ldcg(rq + i * M + 3 + k);
        __syncwarp();
        chol_warp(lf, m, m);
        const T gamma = forward_norm2(lf, m, m, vec);
        if (lane == 0) {
          const T* R = rf + i * 9;
          const T det = ldcg(R) * ldcg(R + 4) * ldcg(R + 8);
          gam[i] = gamma;
          w_ok[i] = active[i] && static_cast<double>(gamma) < thresh[i] && fabs(det) > T(1e-9);
        }
      }
      __syncthreads();
    }
    cluster.sync();

    // ---- the first accepted candidate from lo: those before it are final ----
    int acc = Fc;
    for (int i = lo; i < Fc; ++i)
      if (ldcg(w_ok + i)) {
        acc = i;
        break;
      }
    if (leader)
      for (int i = lo + tid; i < Fc && i <= acc; i += kThreads) {
        chi2[i] = ldcg(gam + i);
        inited[i] = i == acc;
      }
    if (acc == Fc) break;

    // ---- the invertible block ----
    const int i = acc;
    const int slot = static_cast<int>(slots[i]), off = a.slam_off + 3 * slot;
    const int nl = stage(i);
    if (tid == 0) {
      const T* R = rf + i * 9;
      const T r00 = ldcg(R), r01 = ldcg(R + 1), r02 = ldcg(R + 2), r11 = ldcg(R + 4), r12 = ldcg(R + 5),
              r22 = ldcg(R + 8);
      // R^-1 by back substitution on the columns of I
      T* hi = s_hinv;
      hi[8] = T(1) / r22;
      hi[5] = (T(0) - r12 * hi[8]) / r11;
      hi[2] = (T(0) - r01 * hi[5] - r02 * hi[8]) / r00;
      hi[4] = T(1) / r11;
      hi[1] = (T(0) - r01 * hi[4]) / r00;
      hi[0] = T(1) / r00;
      hi[3] = hi[6] = hi[7] = T(0);
      T m3[9], t[9];  // H_init P H_init^T + s2 I, then (R^-1 M3) R^-T
      for (int e = 0; e < 9; ++e)
        m3[e] = ldcg(sfull + static_cast<size_t>(i) * M * M + (e / 3) * M + e % 3) + (e / 3 == e % 3 ? s2 : T(0));
      for (int e = 0; e < 9; ++e)
        t[e] = hi[(e / 3) * 3] * m3[e % 3] + hi[(e / 3) * 3 + 1] * m3[3 + e % 3] + hi[(e / 3) * 3 + 2] * m3[6 + e % 3];
      for (int e = 0; e < 9; ++e)
        s_pll[e] = t[(e / 3) * 3] * hi[(e % 3) * 3] + t[(e / 3) * 3 + 1] * hi[(e % 3) * 3 + 1] +
                   t[(e / 3) * 3 + 2] * hi[(e % 3) * 3 + 2];
      const T* r0 = rq + i * M;
      for (int j = 0; j < 3; ++j)
        s_dxf[j] = hi[j * 3] * ldcg(r0) + hi[j * 3 + 1] * ldcg(r0 + 1) + hi[j * 3 + 2] * ldcg(r0 + 2);
    }
    // P H_init^T on this block's rows, then the cross terms -(.) R^-T
    rows_times(P, D, nullptr, rank, n, nr, live, nl, hv, M, 0, 3, cross + 3 * rank, 3 * n, 1, rowbuf, cap);
    __syncthreads();
    for (int t = tid; t < nr; t += kThreads) {
      T* c = cross + 3 * (rank + t * n);
      const T m0 = ldcg(c), m1 = ldcg(c + 1), m2 = ldcg(c + 2);
      for (int j = 0; j < 3; ++j) c[j] = -(m0 * s_hinv[j * 3] + m1 * s_hinv[j * 3 + 1] + m2 * s_hinv[j * 3 + 2]);
    }
    cluster.sync();  // every block is past its reads of the old covariance
    for (int e = tid; e < nr * 3; e += kThreads) {
      const int r = rank + (e / 3) * n, j = e % 3;
      if (r >= off && r < off + 3) continue;
      const T v = ldcg(cross + 3 * r + j);
      P[static_cast<size_t>(r) * D + off + j] = v;
      P[static_cast<size_t>(off + j) * D + r] = v;
    }
    if (leader) {
      if (tid < 9) P[static_cast<size_t>(off + tid / 3) * D + off + tid % 3] = s_pll[tid];
      if (tid < 3) {
        const Block& sb = s_blocks[a.slam_block];
        mean[sb.off + 3 * slot + tid] = vals0[i * 3 + tid] + s_dxf[tid];
        static_cast<T*>(a.fej_out)[seq * 3 * S + 3 * slot + tid] = vals0[i * 3 + tid];
      }
      if (tid == 0) {
        keep[s_blocks[a.slam_block].row0 + slot] = 1;
        a.meta_out[0][seq * S + slot] = ids[i];
        a.meta_out[1][seq * S + slot] = a.anchor_slot[seq];
        a.meta_out[2][seq * S + slot] = 0;
      }
    }
    cluster.sync();

    // ---- the EKF update with the update rows ----
    rows_times(P, D, nullptr, rank, n, nr, live, nl, hv, M, 3, m, pht + rank, n, D, rowbuf, cap);
    cluster.sync();
    // S = sym(H (P H^T) + s2 I) over the live rows, every block alike
    for (int e = tid; e < nl * m; e += kThreads) {
      const int k = e / m, c = e % m;
      buf[e] = ldcg(pht + static_cast<size_t>(c) * D + live[k]);
    }
    __syncthreads();
    for (int e = tid; e < m * m; e += kThreads) {
      const int r = e / m, c = e % m;
      T acc2 = T(0);
      for (int k = 0; k < nl; ++k) acc2 += hv[k * M + 3 + r] * buf[k * m + c];
      gram[e] = acc2 + (r == c ? s2 : T(0));
    }
    __syncthreads();
    for (int e = tid; e < m * m; e += kThreads) lf[e] = T(0.5) * (gram[e] + gram[(e % m) * m + e / m]);
    __syncthreads();
    if (warp == 0) chol_warp(lf, m, m);
    __syncthreads();
    // S^-1 = L^-T L^-1: L^-1 into `gram`, one thread a column, then S^-1
    // into `lf`
    for (int c = tid; c < m; c += kThreads) {
      for (int j = 0; j < m; ++j) {
        T x = j == c ? T(1) : T(0);
        for (int k = c; k < j; ++k) x -= lf[j * m + k] * gram[k * m + c];
        gram[j * m + c] = j < c ? T(0) : x / lf[j * m + j];
      }
    }
    __syncthreads();
    for (int e = tid; e < m * m; e += kThreads) {
      const int r = e / m, c = e % m;
      T acc2 = T(0);
      for (int k = r > c ? r : c; k < m; ++k) acc2 += gram[k * m + r] * gram[k * m + c];
      lf[e] = acc2;
    }
    // K = (P H^T) S^-1 and dx = K r on this block's rows, as many rows of
    // P H^T staged at a time as the buffer holds
    for (int t0 = 0; t0 < nr; t0 += bufcap / m) {
      const int nt = nr - t0 < bufcap / m ? nr - t0 : bufcap / m;
      __syncthreads();
      for (int e = tid; e < nt * m; e += kThreads) {
        const int t = e / m, c = e % m;
        buf[e] = ldcg(pht + static_cast<size_t>(c) * D + rank + (t0 + t) * n);
      }
      __syncthreads();
      for (int t = tid; t < nt; t += kThreads) {
        const int r = rank + (t0 + t) * n;
        T d = T(0);
        for (int b = 0; b < m; ++b) {
          T acc2 = T(0);
          for (int c = 0; c < m; ++c) acc2 += buf[t * m + c] * lf[b * m + c];
          kt[static_cast<size_t>(b) * D + r] = acc2;
          d += acc2 * ldcg(rq + i * M + 3 + b);
        }
        dxw[r] = d;
      }
    }
    cluster.sync();
    // P <- sym(P - K (P H^T)^T): the pair (r, j <= r) by one thread, kPer
    // pairs a thread at a time over kChunk rows of K and P H^T staged at a
    // time; the single-depth representation's bearing rows and columns
    // zeroed
    {
      T* kc = buf;
      T* pc = buf + kChunk * D;
      const int total = nr * D;
      for (int base = 0; base < total; base += kThreads * kPer) {
        T x[kPer], y[kPer];
#pragma unroll
        for (int q = 0; q < kPer; ++q) x[q] = y[q] = T(0);
        for (int b0 = 0; b0 < m; b0 += kChunk) {
          const int nbc = m - b0 < kChunk ? m - b0 : kChunk;
          __syncthreads();
          for (int e = tid; e < nbc * D; e += kThreads) {
            kc[e] = ldcg(kt + static_cast<size_t>(b0) * D + e);
            pc[e] = ldcg(pht + static_cast<size_t>(b0) * D + e);
          }
          __syncthreads();
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const int e = base + q * kThreads + tid;
            const int r = rank + (e / D) * n, j = e % D;
            if (e < total && j <= r)
              for (int bb = 0; bb < nbc; ++bb) {
                x[q] += kc[bb * D + r] * pc[bb * D + j];
                y[q] += kc[bb * D + j] * pc[bb * D + r];
              }
          }
        }
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int e = base + q * kThreads + tid;
          const int r = rank + (e / D) * n, j = e % D;
          if (e < total && j <= r) {
            const T pij = ldcg(P + static_cast<size_t>(r) * D + j), pji = ldcg(P + static_cast<size_t>(j) * D + r);
            T v = T(0.5) * ((pij - x[q]) + (pji - y[q]));
            if (a.freeze && (r == off || r == off + 1 || j == off || j == off + 1)) v = T(0);
            P[static_cast<size_t>(r) * D + j] = v;
            P[static_cast<size_t>(j) * D + r] = v;
          }
        }
      }
    }
    if (leader)  // inject dx: one thread a row of a mean block
      INJECT_ROWS(mean, keep, s_blocks, a.table.rows, [&](int e) { return ldcg(dxw + e); });
    cluster.sync();
    lo = acc + 1;
  }

  // ---- write back: every mean block and the landmark mask ----
  if (leader) {
    __syncthreads();
    store_mean(mean, s_blocks, a.table.mean_len, seq);
    const Block& sb = s_blocks[a.slam_block];
    for (int s = tid; s < S; s += kThreads) a.slam_valid_out[seq * S + s] = keep[sb.row0 + s];
  }
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  static int max_smem = 0;
  cudaError_t e = opt_in(slam_init_kernel<T>, max_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t bytes = smem_bytes<T>(a);
  if (bytes > static_cast<size_t>(max_smem) ||
      static_cast<size_t>(a.work_bytes) < work_bytes<T>(a.dim, a.fc, a.m_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, slam_init_kernel<T>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `ints` and `ptrs` as `update/slam.py` `kernel_ints` / `_launch` lay them out:
//   ints: is_double, batch, work bytes a sequence, dim, Fc, M, live_cap,
//         slam_off, max_slam, freeze (the single-depth representation), the cluster
//         size, the table index of slam_p, then the table (`parse_table`);
//   ptrs: cov_in, cov_out, hx, hf, res, thresh (float64), active, slots,
//         ids, vals0, anchor_slot, clones_valid, slam_valid, anchors_valid,
//         slam_valid_out, slam_p_fej in and out, slam_id, slam_anchor_slot
//         and slam_anchor_cam in, then out, inited, chi2, work, then per
//         block its input and its output;
//   reals: sigma2.
// Every tensor holds `batch` sequences back to back; `work` holds a
// sequence's workspace each. Returns cudaGetLastError() after the launch
// (or cudaErrorInvalidValue for a table or shape the kernel does not take).
extern "C" int uvio_slam_init(const int64_t* ptrs, const int* ints, const double* reals, cudaStream_t stream) {
  Args a{};
  const int batch = ints[1];
  a.work_bytes = ints[2];
  a.dim = ints[3];
  a.fc = ints[4];
  a.m_rows = ints[5];
  a.live_cap = ints[6];
  a.slam_off = ints[7];
  a.max_slam = ints[8];
  a.freeze = ints[9];
  a.cluster = ints[10];
  a.slam_block = ints[11];
  a.sigma2 = reals[0];
  if (batch < 1 || a.dim < 1 || a.fc < 1 || a.fc > kMaxCands || a.m_rows < 4 || a.m_rows > kMaxRows ||
      a.live_cap < 1 || a.live_cap > a.dim || a.max_slam < 1 || a.cluster < 1 || a.cluster > kMaxCluster ||
      a.cluster > a.fc || a.slam_block < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int p = 0;
  a.cov_in = reinterpret_cast<const void*>(ptrs[p++]);
  a.cov_out = reinterpret_cast<void*>(ptrs[p++]);
  a.hx = reinterpret_cast<const void*>(ptrs[p++]);
  a.hf = reinterpret_cast<const void*>(ptrs[p++]);
  a.res = reinterpret_cast<const void*>(ptrs[p++]);
  a.thresh = reinterpret_cast<const double*>(ptrs[p++]);
  a.active = reinterpret_cast<const bool*>(ptrs[p++]);
  a.slots = reinterpret_cast<const int64_t*>(ptrs[p++]);
  a.ids = reinterpret_cast<const int64_t*>(ptrs[p++]);
  a.vals0 = reinterpret_cast<const void*>(ptrs[p++]);
  a.anchor_slot = reinterpret_cast<const int64_t*>(ptrs[p++]);
  const int64_t* masks = ptrs + p;
  p += 3;
  a.slam_valid_out = reinterpret_cast<bool*>(ptrs[p++]);
  a.fej_in = reinterpret_cast<const void*>(ptrs[p++]);
  a.fej_out = reinterpret_cast<void*>(ptrs[p++]);
  for (int k = 0; k < 3; ++k) a.meta_in[k] = reinterpret_cast<const int64_t*>(ptrs[p++]);
  for (int k = 0; k < 3; ++k) a.meta_out[k] = reinterpret_cast<int64_t*>(ptrs[p++]);
  a.inited = reinterpret_cast<bool*>(ptrs[p++]);
  a.chi2 = reinterpret_cast<void*>(ptrs[p++]);
  a.work = reinterpret_cast<unsigned char*>(ptrs[p++]);
  const int rc = parse_table(ints + 12, masks, ptrs + p, a.table);
  if (rc != 0) return rc;
  if (a.slam_block >= a.table.nblocks || a.table.blocks[a.slam_block].rows != a.max_slam)
    return static_cast<int>(cudaErrorInvalidValue);
  return ints[0] ? launch<double>(a, batch, stream) : launch<float>(a, batch, stream);
}
