// The MSCKF update of one frame from its stacked per-feature systems on, in
// one launch.
//
// Replaces no TPU kernel: `uvio_tpu/update/msckf.py` `msckf_update` is plain
// JAX, and the port's plain version (`update/msckf.py` `msckf_update_ref`)
// runs the nullspace projection as a batched complete QR (on the card one
// cuSOLVER geqrf and orgqr a feature), the gate, a reduced QR of the whole
// stack and a D-row `ekf_update`: some 80 library calls and 600 nodes of the
// step's CUDA graph. This kernel does the same arithmetic in one launch.
//
// Contract: `msckf_update_ref` from `feature_system`'s systems on. With W =
// slam_off - calib_off, the camera calibration and clone columns, outside
// which a feature's H_x is zero (`feature_system`'s support):
//   * projection: for each feature whose triangulation held and that has 4
//     or more rows, three Householder reflections of H_f (M x 3) applied to
//     [H_x on the W columns | r]; the last M - 3 rows are the projected
//     system. Masked rows are zero and stay in place; the plain version's
//     complete QR of the packed rows differs only by rounding and by an
//     orthonormal completion, to which every quantity below is invariant;
//   * gate: gamma = r_p^T (H_p P_ll H_p^T + s2 I)^-1 r_p (NaN where the
//     Cholesky factor fails), kept = gamma < chi2_mult chi2_95(max(rows - 3,
//     1)) (a NaN rejects); chi2 and kept are written for every feature, 0 and
//     false for one that failed before the gate;
//   * compression: the kept features' projected rows (zero rows for the
//     rest) reduced by Householder QR over the W columns and the residual to
//     an upper-triangular R (W x W) and r_c;
//   * update: PHt = P[:, live] R^T, S = sym(R P_ll R^T + s2 I), K = PHt S^-1,
//     P <- sym(P - K PHt^T), dx = K r_c injected into every mean block of the
//     table (`mean_table.cuh`); cov_ok is `ekf_update`'s test of the new
//     diagonal, num_used the kept count.
//
// Bound: bytes and latency. The covariance read and written once and the
// live stacked systems read once is (2 D^2 + F M (W + 4)) sizeof(T):
// 1,714,944 B for the EuRoC cell's float64 layout, 0.51 us at 3.35 TB/s. The
// time is a chain of dependent steps, so the design keeps it short:
//   * one cluster of n blocks a sequence (a batch, a vmapped step,
//     takes one cluster each); block b projects and gates features b, b + n,
//     ... with the covariance's W x W live block, and each feature's Gram
//     matrix for its gate, in its shared memory;
//   * the compression keeps each block's projected rows in its shared
//     memory, the stack's rows spread over the cluster; a Householder step
//     needs a column's norm and its products with the columns after it, and
//     v^T a_c follows from x^T a_c and the pivot row, so each step is one
//     exchange and one cluster barrier: each block stores its partial sums
//     (and the pivot row, where it holds it) into every block's shared
//     memory, so that after the barrier every read is local. A step costs
//     ~2.5 us with 63 rows a block or 105, a chain of latencies (sums, FP64
//     square root and divisions, the row update), not the barrier: panels of
//     8 columns, each reduced in every block and then on the stack of every
//     block's pivot rows (one barrier a panel), paid that chain twice a
//     column and were slower;
//   * the update's small system (L^-1 of the W x W S, by one elimination
//     that factors S and inverts the factor together) is solved by every
//     block alike in its shared memory, so no block waits to be told; the
//     rows of PHt, S, K and P are split over the blocks (rows r = rank mod
//     n), which meet at the cluster barrier and read what others wrote past
//     L1 (`ld.global.cg`); in the covariance update a thread takes a column
//     of kRowTile of its block's rows, those rows of K and PHt in shared
//     memory and the column's streamed from L2.

#include <cooperative_groups.h>

#include "mean_table.cuh"
#include "small_linalg.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;     // M = 2 K C, a feature's stacked rows
constexpr int kCluster = 16;     // blocks a sequence (past 8 a non-portable cluster size, which the H100 takes)
constexpr int kMaxLocal = 32;    // features a block
constexpr int kRowTile = 8;      // rows of the covariance a thread updates at a time

struct Args {
  const void* cov_in;
  void* cov_out;
  const void* hx;          // (F, M, D)
  const void* hf;          // (F, M, 3)
  const void* res;         // (F, M)
  const bool* row_mask;    // (F, M)
  const bool* tri_ok;      // (F,)
  const double* chi2_95;   // the quantile of each dof, index 0 unused
  bool* kept;
  void* chi2;
  int64_t* num_used;
  bool* cov_ok;
  unsigned char* work;
  size_t work_bytes;  // a sequence's share of `work`
  int dim, feats, m_rows, calib_off, width;
  double sigma2, chi2_mult;
  Table table;
};

// rows of the stack a block holds: its features' projected rows
__host__ __device__ inline int local_rows(int F, int M, int n) { return (F + n - 1) / n * (M - 3); }

// a leading dimension for rows whose columns a warp reads down: odd, so
// that the rows fall on distinct shared-memory banks
__host__ __device__ inline int odd_ld(int n) { return n | 1; }

// A sequence's workspace, in values of T: the projected rows (F, M - 3,
// W + 1), R (W, W + 1), P H^T (W, D), S (W, W), K^T (W, D), dx (D), the new
// diagonal (D); then the kept count of each block in ints.
struct Work {
  size_t hq, rg, pht, sg, kt, dx, diag, values;
};

__host__ __device__ inline Work work_layout(int D, int F, int M, int W) {
  Work w{};
  size_t o = 0;
  w.hq = o, o += static_cast<size_t>(F) * (M - 3) * (W + 1);
  w.rg = o, o += static_cast<size_t>(W) * (W + 1);
  w.pht = o, o += static_cast<size_t>(W) * D;
  w.sg = o, o += static_cast<size_t>(W) * W;
  w.kt = o, o += static_cast<size_t>(W) * D;
  w.dx = o, o += D;
  w.diag = o, o += D;
  w.values = o;
  return w;
}

// bytes of a sequence's workspace, a multiple of 16
size_t work_bytes(int D, int F, int M, int W, size_t value_bytes) {
  const size_t b = work_layout(D, F, M, W).values * value_bytes + kCluster * sizeof(int);
  return (b + 15) / 16 * 16;
}

// Values of the shared region that the phases take in turn:
//   projection and gates: P_ll (W x W), the feature's [H_x | r] on the live
//     columns (M x odd_ld(W + 1)), H_p P_ll ((M - 3) x W), each local
//     feature's H_f and reflections (3 M + 3 a feature), its Gram matrix and
//     r_p ((M - 3)^2 + M - 3 a feature);
//   compression: the block's rows of the stack (local_rows x (W + 1)), the
//     partial sums (kThreads), every block's sums and the pivot row, twice
//     ((2 n + 2) x (W + 1)), the step's factors (W + 1);
//   update: R, then L^-1 (W x (W + 1)); P H^T's live rows, then S, then
//     staged rows of P H^T and their products with L^-1 (W x W); r_c and
//     S^-1 r_c (2 W), a warp's row of P (kWarps x W);
//     then stretches of this block's rows of K and P H^T (2 x W rows of W,
//     within R's and S's share).
// Sized from W, M, F and the cluster size, never from D.
__host__ __device__ inline size_t region_values(int F, int M, int W, int n) {
  const size_t m = M - 3, W1 = W + 1, nfl = (F + n - 1) / n;
  const size_t proj = static_cast<size_t>(W) * W + M * odd_ld(W + 1) + m * W + nfl * (3 * M + 3 + m * m + m);
  const size_t qr = local_rows(F, M, n) * (W1 + 2) + kThreads + (2 * n + 3) * W1;
  const size_t upd = static_cast<size_t>(W) * W1 + static_cast<size_t>(W) * W + 2 * W + kWarps * W;
  size_t v = proj > qr ? proj : qr;
  return v > upd ? v : upd;
}

// dynamic shared memory: the region, then the mean (values) and each block
// row's mask (bytes)
template <typename T>
size_t smem_bytes(const Args& a) {
  return (region_values(a.feats, a.m_rows, a.width, kCluster) + a.table.mean_len) * sizeof(T) + a.table.rows;
}

// X = L^-1 for the lower Cholesky factor L of the n x n matrix A (leading
// dimension n, lower triangle read and overwritten) by the whole block, one
// barrier a column: Gaussian elimination of A's column j applied to the
// identity gives L_u^-1 for A = L_u D L_u^T, and L^-1 = D^-1/2 L_u^-1. A
// pivot that is not positive (or NaN) fills X with NaN, as the plain
// version's failed factorization does. `d` holds n values.
template <typename T>
__device__ void inv_chol_block(T* A, T* X, int n, T* d) {
  // thread (k, i0): column k of the rows i0, i0 + rs, ... (n <= kThreads)
  const int k = threadIdx.x % n, i0 = threadIdx.x / n, rs = kThreads / n;
  const bool on = i0 < rs;
  for (int i = i0; on && i < n; i += rs) X[i * n + k] = i == k ? T(1) : T(0);
  __syncthreads();
  bool ok = true;
  for (int j = 0; j < n; ++j) {
    const T piv = A[j * n + j];  // every thread reads the same pivot
    ok = piv > T(0);
    if (!ok) break;
    if (threadIdx.x == 0) d[j] = piv;
    const T inv = T(1) / piv;
    if (on) {  // X's or A's column k on the rows below, four rows' loads ahead of their stores
      const bool lower = k <= j;
      T* Y = lower ? X : A;
      const T f = (lower ? X[j * n + k] : A[k * n + j]) * inv;
      for (int i = lower ? j + 1 + i0 : k + ((j + 1 + i0 - k) % rs + rs) % rs; i < n; i += 4 * rs) {
        T aij[4], yik[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i + u * rs < n) {
            aij[u] = A[(i + u * rs) * n + j];
            yik[u] = Y[(i + u * rs) * n + k];
          }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i + u * rs < n) Y[(i + u * rs) * n + k] = yik[u] - aij[u] * f;
      }
    }
    __syncthreads();
  }
  __syncthreads();
  for (int i = i0; on && i < n; i += rs) {
    if (!ok)
      X[i * n + k] = T(NAN);
    else if (k <= i)
      X[i * n + k] /= sqrt(d[i]);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) msckf_update_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Block s_blocks[kMaxBlocks];
  __shared__ int s_keep[kMaxLocal];  // a local feature's weight: 1 kept, 0 rejected, -1 no rows
  __shared__ int s_rows[kMaxLocal];

  const int D = a.dim, F = a.feats, M = a.m_rows, m = M - 3, W = a.width, W1 = W + 1, c0 = a.calib_off;
  const int n = kCluster, rank = blockIdx.x, seq = blockIdx.y, tid = threadIdx.x, lane = tid % 32,
            warp = tid / 32;
  const int nf = (F - rank + n - 1) / n;  // this block's features: rank, rank + n, ...
  const int nfl = (F + n - 1) / n;         // the most features a block has
  const int NL = local_rows(F, M, n);
  const int nr = (D - rank + n - 1) / n;  // this block's covariance rows: rank, rank + n, ...
  const bool leader = rank == 0;
  const T s2 = static_cast<T>(a.sigma2);

  T* region = reinterpret_cast<T*>(smem);
  T* mean = region + region_values(F, M, W, n);
  unsigned char* keep = reinterpret_cast<unsigned char*>(mean + a.table.mean_len);

  const size_t DD = static_cast<size_t>(D) * D;
  const T* cov_in = static_cast<const T*>(a.cov_in) + seq * DD;
  T* cov_out = static_cast<T*>(a.cov_out) + seq * DD;
  const T* hx = static_cast<const T*>(a.hx) + static_cast<size_t>(seq) * F * M * D;
  const T* hf = static_cast<const T*>(a.hf) + static_cast<size_t>(seq) * F * M * 3;
  const T* res = static_cast<const T*>(a.res) + static_cast<size_t>(seq) * F * M;
  const bool* row_mask = a.row_mask + static_cast<size_t>(seq) * F * M;
  const bool* tri_ok = a.tri_ok + seq * F;
  bool* kept = a.kept + seq * F;
  T* chi2 = static_cast<T*>(a.chi2) + seq * F;

  unsigned char* wb = a.work + static_cast<size_t>(seq) * a.work_bytes;
  const Work w = work_layout(D, F, M, W);
  T* wv = reinterpret_cast<T*>(wb);
  T* hq = wv + w.hq;
  T* rg = wv + w.rg;
  T* pht = wv + w.pht;  // [k][r]
  T* sg = wv + w.sg;
  T* kt = wv + w.kt;    // [k][r]
  T* dxw = wv + w.dx;
  T* diag = wv + w.diag;
  int* counts = reinterpret_cast<int*>(wb + w.values * sizeof(T));

  load_table(s_blocks, a.table);

  // ---- projection and gate of this block's features ----
  {
    const int ld = odd_ld(W1), mg = m * m + m;
    T* pll = region;
    T* hv = pll + W * W;  // [k][c], the residual in column W
    T* t1 = hv + M * ld;
    T* hhs = t1 + m * W;  // each local feature's H_f, then its reflections
    T* taus = hhs + nfl * 3 * M;
    T* grs = taus + nfl * 3;  // each local feature's Gram matrix, then r_p
    for (int e = tid; e < W * W; e += kThreads) pll[e] = cov_in[static_cast<size_t>(c0 + e / W) * D + c0 + e % W];
    for (int e = tid; e < nf * 3 * M; e += kThreads)
      hhs[e] = hf[static_cast<size_t>(rank + e / (3 * M) * n) * M * 3 + e % (3 * M)];
    __syncthreads();
    for (int i = warp; i < nf; i += kWarps) {  // a warp a feature: its rows, then its reflections
      const int f = rank + i * n;
      int rows = 0;
      for (int k0 = 0; k0 < M; k0 += 32)
        rows += __popc(__ballot_sync(0xffffffffu, k0 + lane < M && row_mask[f * M + k0 + lane]));
      const bool ok = tri_ok[f] && rows >= 4;
      if (lane == 0) {
        s_rows[i] = rows;
        s_keep[i] = ok ? 0 : -1;
        if (!ok) {  // failed before the gate: no rows
          chi2[f] = T(0);
          kept[f] = false;
        }
      }
      if (ok) householder3_warp(hhs + i * 3 * M, M, taus + 3 * i);
    }
    __syncthreads();
    for (int i = 0; i < nf; ++i) {
      if (s_keep[i] < 0) continue;
      const int f = rank + i * n;
      __syncthreads();
      for (int e = tid; e < M * W1; e += kThreads) {
        const int k = e / W1, c = e % W1;
        hv[k * ld + c] = c < W ? hx[(static_cast<size_t>(f) * M + k) * D + c0 + c] : res[f * M + k];
      }
      __syncthreads();
      for (int col = tid; col < W1; col += kThreads) reflect3(hv + col, ld, hhs + i * 3 * M, taus + 3 * i, M);
      __syncthreads();
      // H_p P_ll, four rows a thread; the projected rows out to the workspace
      for (int e = tid; e < (m + 3) / 4 * W; e += kThreads) {
        const int r0 = e / W * 4, c = e % W;
        const T* h = hv + (3 + r0) * ld;  // past the last row: read, never stored
        T acc[4] = {T(0), T(0), T(0), T(0)};
        for (int k = 0; k < W; ++k) {
          const T p = pll[k * W + c];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] += h[q * ld + k] * p;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (r0 + q < m) t1[(r0 + q) * W + c] = acc[q];
      }
      for (int e = tid; e < m * W1; e += kThreads) hq[static_cast<size_t>(f) * m * W1 + e] = hv[(3 + e / W1) * ld + e % W1];
      for (int k = tid; k < m; k += kThreads) grs[i * mg + m * m + k] = hv[(3 + k) * ld + W];
      __syncthreads();
      for (int e = tid; e < m * m; e += kThreads) {
        const int r = e / m, c = e % m;
        const T* h = hv + (3 + c) * ld;
        T acc = T(0);
        for (int k = 0; k < W; ++k) acc += t1[r * W + k] * h[k];
        grs[i * mg + e] = acc + (r == c ? s2 : T(0));
      }
    }
    __syncthreads();
    // the gates, a warp a feature: gamma = |L^-1 r_p|^2
    for (int i = warp; i < nf; i += kWarps) {
      if (s_keep[i] < 0) continue;
      const int f = rank + i * n;
      T* g = grs + i * mg;
      T* v = g + m * m;
      chol_warp(g, m, m);
      const T gamma = forward_norm2(g, m, m, v);
      if (lane == 0) {
        const int dof = s_rows[i] - 3 < 1 ? 1 : (s_rows[i] - 3 > m ? m : s_rows[i] - 3);
        const bool k = static_cast<double>(gamma) < a.chi2_mult * a.chi2_95[dof];
        chi2[f] = gamma;
        kept[f] = k;
        s_keep[i] = k;
      }
    }
    __syncthreads();
    if (tid == 0) {
      int c = 0;
      for (int i = 0; i < nf; ++i) c += s_keep[i] > 0;
      counts[rank] = c;
    }
  }

  // ---- compression: Householder QR of the stack over the cluster ----
  {
    T* st = region;  // [local row][c]; local row l holds global row l n + rank
    T* part = st + static_cast<size_t>(NL) * W1;
    T* xs = part + kThreads;  // [2][n][W + 1]: every block's partial sums, pushed by each
    T* xp = xs + 2 * n * W1;  // [2][W + 1]: the pivot row, pushed by the block that holds it
    T* coef = xp + 2 * W1;
    T* xcol = coef + W1;  // [2][NL]: the pivot column of this block's rows (column j at step j)
    for (int e = tid; e < NL * W1; e += kThreads) {  // weighted as the plain version weights them
      const int l = e / W1, i = l / m, c = e % W1;
      st[e] = i < nf && s_keep[i] >= 0
                  ? ldcg(hq + (static_cast<size_t>(rank + i * n) * m + l % m) * W1 + c) * static_cast<T>(s_keep[i])
                  : T(0);
    }
    cluster.sync();  // every block is past its gates before any block stores into its shared memory
    {  // step 0's partial sums x^T a_c over this block's rows, in G groups of rows
      const int G = kThreads / W1, l0 = rank > 0 ? 0 : 1;
      for (int l = tid; l < NL; l += kThreads) xcol[l] = st[l * W1];
      if (tid < G * W1) {
        const int c = tid % W1;
        T acc = T(0);
        for (int l = l0 + tid / W1; l < NL; l += G) acc += st[l * W1] * st[l * W1 + c];
        part[tid] = acc;
      }
    }
    __syncthreads();
    for (int j = 0; j < W; ++j) {
      const int buf = j & 1, nc = W1 - j, po = j % n, lp = j / n, G = kThreads / nc;
      const T* x = xcol + buf * NL;
      if (tid < nc) {  // this block's sums, and the pivot row, into every block
        T s = T(0);
        for (int g = 0; g < G; ++g) s += part[g * nc + tid];
        const T piv = rank != po ? T(0) : tid == 0 ? x[lp] : st[lp * W1 + j + tid];
        for (int b = 0; b < n; ++b) {
          cluster.map_shared_rank(xs, b)[(buf * n + rank) * W1 + tid] = s;
          if (rank == po) cluster.map_shared_rank(xp, b)[buf * W1 + tid] = piv;
        }
      }
      cluster.sync();
      if (tid < nc) {  // the reflection, alike in every block
        T sj = T(0), sc = T(0);
        for (int b = 0; b < n; ++b) {
          sj += xs[(buf * n + b) * W1];
          sc += xs[(buf * n + b) * W1 + tid];
        }
        const T alpha = xp[buf * W1], pc = xp[buf * W1 + tid];
        T tau = T(0), beta = alpha, scale = T(0);
        if (sj != T(0)) {
          beta = -copysign(sqrt(alpha * alpha + sj), alpha);
          tau = (beta - alpha) / beta;
          scale = T(1) / (alpha - beta);
        }
        const T wc = tau * (pc + scale * sc);  // tau v^T a_c
        coef[tid] = scale * wc;
        if (rank == po) st[lp * W1 + j + tid] = tid == 0 ? beta : pc - wc;
      }
      __syncthreads();
      // the rows below the pivot through the reflection, and step j + 1's
      // partial sums on the way: column j + 1's new values go to the other
      // half of xcol, so that every thread reads its old ones
      if (j + 1 < W) {
        const int nc1 = nc - 1, G1 = kThreads / nc1;
        const int l0 = j < rank ? 0 : (j - rank) / n + 1, l1 = j + 1 < rank ? 0 : (j + 1 - rank) / n + 1;
        T* xn = xcol + (1 - buf) * NL;
        const T c1 = coef[1];
        if (tid < G1 * nc1) {
          const int c = j + 1 + tid % nc1;
          const T cc = coef[c - j];
          T acc = T(0);
          for (int l = l0 + tid / nc1; l < NL; l += G1) {
            const T xl = x[l];
            const T x1 = st[l * W1 + j + 1] - xl * c1;
            T v;
            if (c == j + 1) {
              v = x1;
              xn[l] = x1;
            } else {
              v = st[l * W1 + c] - xl * cc;
              st[l * W1 + c] = v;
            }
            if (l >= l1) acc += x1 * v;
          }
          part[tid] = acc;
        }
      }
      __syncthreads();
    }
    // this block's rows of R out to the workspace
    const int nrows_r = (W - rank + n - 1) / n;
    for (int e = tid; e < nrows_r * W1; e += kThreads) {
      const int l = e / W1, c = e % W1, g = l * n + rank;
      rg[static_cast<size_t>(g) * W1 + c] = c >= g ? st[e] : T(0);
    }
  }
  cluster.sync();

  // ---- the EKF update with the W-row system ----
  T* ra = region;                               // R, then L^-1
  T* rb = ra + static_cast<size_t>(W) * W1;     // P H^T's live rows, then S, then staged rows
  T* rc = rb + static_cast<size_t>(W) * W;      // r_c
  T* u = rc + W;                                // the pivots, then S^-1 r_c
  T* wrows = u + W;                             // a warp's row of P

  for (int e = tid; e < W * W1; e += kThreads) ra[e] = ldcg(rg + e);
  __syncthreads();
  for (int k = tid; k < W; k += kThreads) rc[k] = ra[k * W1 + W];
  {  // P H^T = P[:, live] R^T on this block's rows, one warp a row
    T* wrow = wrows + warp * W;
    for (int ri = warp; ri < nr; ri += kWarps) {
      const int r = rank + ri * n;
      __syncwarp();
      for (int k = lane; k < W; k += 32) wrow[k] = cov_in[static_cast<size_t>(r) * D + c0 + k];
      __syncwarp();
      for (int k = lane; k < W; k += 32) {
        T acc = T(0);
        for (int c = k; c < W; ++c) acc += wrow[c] * ra[k * W1 + c];
        pht[static_cast<size_t>(k) * D + r] = acc;
      }
    }
  }
  cluster.sync();
  // S = R (P H^T)[live] + s2 I on the rows i = rank mod n
  for (int e = tid; e < W * W; e += kThreads) rb[e] = ldcg(pht + static_cast<size_t>(e / W) * D + c0 + e % W);
  __syncthreads();
  for (int e = tid; e < (W - rank + n - 1) / n * W; e += kThreads) {
    const int i = rank + (e / W) * n, k = e % W;
    T acc = T(0);
    for (int c = i; c < W; ++c) acc += ra[i * W1 + c] * rb[k * W + c];
    sg[i * W + k] = acc + (i == k ? s2 : T(0));
  }
  cluster.sync();
  // L^-1 for S = L L^T, every block alike; u = S^-1 r_c = L^-T (L^-1 r_c)
  for (int e = tid; e < W * W; e += kThreads) rb[e] = T(0.5) * (ldcg(sg + e) + ldcg(sg + (e % W) * W + e / W));
  __syncthreads();
  inv_chol_block(rb, ra, W, u);  // X = L^-1 in ra, leading dimension W
  T* tmp = wrows;
  for (int i = tid; i < W; i += kThreads) {
    T acc = T(0);
    for (int k = 0; k <= i; ++k) acc += ra[i * W + k] * rc[k];
    tmp[i] = acc;
  }
  __syncthreads();
  for (int j = tid; j < W; j += kThreads) {
    T acc = T(0);
    for (int i = j; i < W; ++i) acc += ra[i * W + j] * tmp[i];
    u[j] = acc;
  }
  // K = P H^T S^-1 (a row: L^-T (L^-1 (P H^T)_r)) and dx = P H^T u on this
  // block's rows, a stretch of rows of P H^T staged at a time
  const int stretch = W / 2;
  T* prow = rb;
  T* z = rb + static_cast<size_t>(stretch) * W;
  for (int t0 = 0; t0 < nr; t0 += stretch) {
    const int nt = nr - t0 < stretch ? nr - t0 : stretch;
    __syncthreads();
    for (int e = tid; e < nt * W; e += kThreads)
      prow[e] = ldcg(pht + static_cast<size_t>(e % W) * D + rank + (t0 + e / W) * n);
    __syncthreads();
    for (int e = tid; e < nt * W; e += kThreads) {
      const int t = e / W, i = e % W;
      T acc = T(0);
      for (int k = 0; k <= i; ++k) acc += ra[i * W + k] * prow[t * W + k];
      z[e] = acc;
    }
    for (int t = tid; t < nt; t += kThreads) {
      T acc = T(0);
      for (int c = 0; c < W; ++c) acc += prow[t * W + c] * u[c];
      dxw[rank + (t0 + t) * n] = acc;
    }
    __syncthreads();
    for (int e = tid; e < nt * W; e += kThreads) {
      const int t = e / W, j = e % W;
      T acc = T(0);
      for (int i = j; i < W; ++i) acc += ra[i * W + j] * z[t * W + i];
      kt[static_cast<size_t>(j) * D + rank + (t0 + t) * n] = acc;
    }
  }
  cluster.sync();
  if (leader) {  // inject dx: one thread a row of a mean block
    stage_mean(mean, keep, s_blocks, a.table, seq);
    __syncthreads();
    INJECT_ROWS(mean, keep, s_blocks, a.table.rows, [&](int e) { return ldcg(dxw + e); });
  }
  // P <- sym(P - K (P H^T)^T) on this block's rows r: thread (g, j) takes
  // the pairs (r, j <= r) of the rows of group g (kRowTile rows) with those
  // rows of K and P H^T in shared memory and column j's streamed from L2,
  // four columns of K^T and P H^T in flight
  {
    const int cap = W;                // rows of K and P H^T that R's and S's share of the region holds
    T* kr = region;                   // [t][k]: K's row r = rank + t n
    T* pr = region + static_cast<size_t>(cap) * W;
    for (int t0 = 0; t0 < nr; t0 += cap) {
      const int nt = nr - t0 < cap ? nr - t0 : cap, groups = (nt + kRowTile - 1) / kRowTile;
      __syncthreads();
      for (int e = tid; e < nt * W; e += kThreads) {
        const size_t at = static_cast<size_t>(e % W) * D + rank + (t0 + e / W) * n;
        kr[e] = ldcg(kt + at);
        pr[e] = ldcg(pht + at);
      }
      __syncthreads();
      for (int e = tid; e < groups * D; e += kThreads) {
        const int g = e / D, j = e % D, tg = g * kRowTile, ng = nt - tg < kRowTile ? nt - tg : kRowTile;
        T x[kRowTile], y[kRowTile];
#pragma unroll
        for (int q = 0; q < kRowTile; ++q) x[q] = y[q] = T(0);
        for (int k0 = 0; k0 < W; k0 += 4) {
          T kj[4], pj[4];
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (k0 + v < W) {
              kj[v] = ldcg(kt + static_cast<size_t>(k0 + v) * D + j);
              pj[v] = ldcg(pht + static_cast<size_t>(k0 + v) * D + j);
            }
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (k0 + v < W)
#pragma unroll
              for (int q = 0; q < kRowTile; ++q)
                if (q < ng) {
                  x[q] += kr[(tg + q) * W + k0 + v] * pj[v];
                  y[q] += kj[v] * pr[(tg + q) * W + k0 + v];
                }
        }
#pragma unroll
        for (int q = 0; q < kRowTile; ++q) {
          const int r = rank + (t0 + tg + q) * n;
          if (q < ng && j <= r) {
            const T v = T(0.5) * ((cov_in[static_cast<size_t>(r) * D + j] - x[q]) +
                                  (cov_in[static_cast<size_t>(j) * D + r] - y[q]));
            cov_out[static_cast<size_t>(r) * D + j] = v;
            cov_out[static_cast<size_t>(j) * D + r] = v;
            if (j == r) diag[r] = v;
          }
        }
      }
    }
  }
  cluster.sync();

  // ---- the leader's outputs: cov_ok, num_used, every mean block ----
  if (leader) {
    if (warp == 0) {  // ekf_update's test: diag > -max(32 eps max(max diag, 1), 1e-9), NaN failing
      T mx = T(-INFINITY);
      bool nan = false;
      for (int r = lane; r < D; r += 32) {
        const T v = ldcg(diag + r);
        nan = nan || v != v;
        mx = v > mx ? v : mx;
      }
      for (int o = 16; o > 0; o >>= 1) mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const T eps = sizeof(T) == 8 ? T(2.220446049250313e-16) : T(1.1920928955078125e-07);
      const T tol = fmax(T(32) * eps * fmax(mx, T(1)), T(1e-9));
      bool ok = !nan;
      for (int r = lane; r < D; r += 32) ok = ok && ldcg(diag + r) > -tol;
      ok = __all_sync(0xffffffffu, ok);
      if (lane == 0) {
        int used = 0;
        for (int b = 0; b < n; ++b) used += ldcg(counts + b);
        a.num_used[seq] = used;
        a.cov_ok[seq] = ok;
      }
    }
    store_mean(mean, s_blocks, a.table.mean_len, seq);
  }
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  static int max_smem = 0;
  static bool nonportable = false;  // the cluster size allowed (once, before any capture)
  cudaError_t e = opt_in(msckf_update_kernel<T>, max_smem);
  if (e == cudaSuccess && !nonportable) {
    e = cudaFuncSetAttribute(msckf_update_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    nonportable = e == cudaSuccess;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t bytes = smem_bytes<T>(a);
  if (bytes > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, msckf_update_kernel<T>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `ints` and `ptrs` as `update/msckf.py` `kernel_ints` / `_launch` lay them out:
//   ints: is_double, batch, dim, F, M, calib_off, W, then the table
//         (`parse_table`);
//   ptrs: cov_in, cov_out, hx, hf, res, row_mask, tri_ok, the chi2 quantiles
//         (float64), clones_valid, slam_valid, anchors_valid, kept, chi2,
//         num_used, cov_ok, work, then per block its input and its output;
//   reals: sigma2, chi2_mult.
// Every tensor holds `batch` sequences back to back but the quantiles;
// `work` holds `uvio_msckf_work_bytes` a sequence. Returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for a table
// or shape the kernel does not take).
extern "C" int uvio_msckf_update(const int64_t* ptrs, const int* ints, const double* reals, cudaStream_t stream) {
  Args a{};
  const int batch = ints[1];
  a.dim = ints[2];
  a.feats = ints[3];
  a.m_rows = ints[4];
  a.calib_off = ints[5];
  a.width = ints[6];
  a.sigma2 = reals[0];
  a.chi2_mult = reals[1];
  a.work_bytes = work_bytes(a.dim, a.feats, a.m_rows, a.width, ints[0] ? sizeof(double) : sizeof(float));
  if (batch < 1 || a.dim < 1 || a.feats < 1 || a.feats > kCluster * kMaxLocal || a.m_rows < 4 ||
      a.m_rows > kMaxRows || a.width < 2 || a.calib_off < 0 || a.calib_off + a.width > a.dim ||
      a.width >= kThreads || local_rows(a.feats, a.m_rows, kCluster) * kCluster < a.width)
    return static_cast<int>(cudaErrorInvalidValue);
  int p = 0;
  a.cov_in = reinterpret_cast<const void*>(ptrs[p++]);
  a.cov_out = reinterpret_cast<void*>(ptrs[p++]);
  a.hx = reinterpret_cast<const void*>(ptrs[p++]);
  a.hf = reinterpret_cast<const void*>(ptrs[p++]);
  a.res = reinterpret_cast<const void*>(ptrs[p++]);
  a.row_mask = reinterpret_cast<const bool*>(ptrs[p++]);
  a.tri_ok = reinterpret_cast<const bool*>(ptrs[p++]);
  a.chi2_95 = reinterpret_cast<const double*>(ptrs[p++]);
  const int64_t* masks = ptrs + p;
  p += 3;
  a.kept = reinterpret_cast<bool*>(ptrs[p++]);
  a.chi2 = reinterpret_cast<void*>(ptrs[p++]);
  a.num_used = reinterpret_cast<int64_t*>(ptrs[p++]);
  a.cov_ok = reinterpret_cast<bool*>(ptrs[p++]);
  a.work = reinterpret_cast<unsigned char*>(ptrs[p++]);
  const int rc = parse_table(ints + 7, masks, ptrs + p, a.table);
  if (rc != 0) return rc;
  return ints[0] ? launch<double>(a, batch, stream) : launch<float>(a, batch, stream);
}

// The bytes of a sequence's workspace that `uvio_msckf_update` takes with
// these sizes, in float64 (is_double) or float32.
extern "C" int uvio_msckf_work_bytes(int is_double, int dim, int feats, int m_rows, int width) {
  return static_cast<int>(work_bytes(dim, feats, m_rows, width, is_double ? sizeof(double) : sizeof(float)));
}
