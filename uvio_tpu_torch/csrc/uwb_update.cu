// The sequential single-range UWB updates of one range set, in one launch.
//
// Replaces no TPU kernel: `uvio_tpu/update/uwb.py` `uwb_update` is plain
// JAX, and the port's plain version (`update/uwb.py` `uwb_update_ref`)
// runs each anchor slot as a general `ekf_update` with one row plus a
// select of every state field, about 250 small launches a slot and some
// 2,000 nodes of the step's CUDA graph for the corridor's 8 slots. This
// kernel does the same arithmetic in one block.
//
// Contract: `uwb_update_ref`. For slot a = 0..A-1 in order, at the mean
// the previous accepted update left:
//   valid = range_mask[a] & anchors_valid[a]; an invalid slot writes
//   chi2 0 and accepted false and changes nothing;
//   y_hat = (1 + alpha_a) d + gamma_a, d = |p_A - p_U|, p_U = p - R^T l,
//   H's nonzeros: theta(3), p(3), the lever arm l(3) when it is in the
//   error state, and the anchor's p_A, gamma, alpha (5);
//   S = H P H^T + sigma^2, gamma = r^2 / S, accepted = gamma < thresh
//   (a NaN gamma rejects); on accept K = P H^T / S (NaN where S <= 0, as
//   the plain version's Cholesky fails), P <- sym(P - K (P H^T)^T) and
//   dx = K r injected into every mean block the layout has (quaternions
//   by the error quaternion's product, the rest added; rows of invalid
//   clones, landmarks and anchors left alone). FEJ values are untouched.
//
// Bound: bytes. The covariance read and written once is 2 D^2 sizeof(T):
// 270,400 B for the corridor's float64 D = 130, 0.08 us at 3.35 TB/s;
// the arithmetic (4 rank-1 updates of a 130 x 130 matrix) is ~0.07 MFLOP.
// So the time is the launch and one block's chain of dependent steps, and
// the design keeps that chain off device memory:
//   * one block of kThreads runs the whole chain: each slot's Jacobian
//     and predicted range depend on the mean the previous slot left, so
//     the slots cannot run side by side; a batch (a vmapped step) takes
//     one block a sequence;
//   * everything a slot reads is staged once into shared memory with all
//     loads in flight together: the mean blocks (a table of offsets, one
//     thread a value), the ranges, the masks, and the covariance when it
//     fits (with the rest, in the block's 227 KB less its static part:
//     float64 up to about D = 168); else the same code updates the output
//     covariance in place in global memory, where L2 holds it. `launch`
//     picks by shape;
//   * thread 0 forms H's at most 14 nonzeros and the scalars; P H^T reads
//     only those columns; the symmetric rank-1 update gives each pair
//     (i, j <= i) to one thread, one warp a row, so it runs in place; the
//     mean is corrected in shared memory, one thread a block row;
//   * the products of the update are rounded before the subtraction (no
//     FMA contraction), as the plain version's outer product is.

#include "mean_table.cuh"

namespace {

constexpr int kMaxNnz = 14;  // nonzeros of one range's H

struct Args {
  const void* cov_in;
  void* cov_out;
  const void* lever_in;
  const void* ranges;
  const bool* range_mask;
  bool* accepted;
  void* chi2;
  int dim, anchors, theta_off, p_off, lever_off, anchor_off;
  int q_block, p_block, lever_block, ap_block, ag_block, aa_block;
  double sigma2, thresh;
  Table table;
};

// Dynamic shared memory, in values of T: P H^T (D), K (D), the mean
// (mean_len), the ranges (A), the covariance (D^2, when staged); then
// bytes: each block row's mask (rows) and each slot's validity (A).
template <typename T>
size_t smem_bytes(const Args& a, bool cov) {
  const size_t values = 2 * static_cast<size_t>(a.dim) + a.table.mean_len + a.anchors +
                        (cov ? static_cast<size_t>(a.dim) * a.dim : 0);
  return values * sizeof(T) + a.table.rows + a.anchors;
}

template <typename T, bool kSmem>
__global__ void __launch_bounds__(kThreads) uwb_update_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Block s_blocks[kMaxBlocks];
  __shared__ int s_idx[kMaxNnz];
  __shared__ T s_h[kMaxNnz];
  __shared__ T s_lever[3];
  __shared__ int s_nnz, s_go;
  __shared__ T s_r, s_l;

  const int D = a.dim, A = a.anchors, b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  T* pht = reinterpret_cast<T*>(smem);
  T* kg = pht + D;
  T* mean = kg + D;
  T* ranges = mean + a.table.mean_len;
  T* cov_staged = ranges + A;
  unsigned char* keep = reinterpret_cast<unsigned char*>(cov_staged + (kSmem ? D * D : 0));
  unsigned char* valid = keep + a.table.rows;
  const T* cov_in = static_cast<const T*>(a.cov_in) + static_cast<size_t>(b) * D * D;
  T* cov_out = static_cast<T*>(a.cov_out) + static_cast<size_t>(b) * D * D;
  T* P = kSmem ? cov_staged : cov_out;

  // ---- stage: the block table, the covariance, the mean, the ranges,
  // the masks, all loads in flight together ----
  load_table(s_blocks, a.table);
  __syncthreads();
  copy_values(P, cov_in, D * D, [](int i) { return i; });
  stage_mean(mean, keep, s_blocks, a.table, b);
  for (int s = tid; s < A; s += kThreads) {
    ranges[s] = static_cast<const T*>(a.ranges)[b * A + s];
    valid[s] = a.range_mask[b * A + s] && a.table.masks[2][b * A + s];
  }
  if (tid < 3 && a.lever_block < 0) s_lever[tid] = static_cast<const T*>(a.lever_in)[b * 3 + tid];
  __syncthreads();

  bool* accepted = a.accepted + b * A;
  T* chi2 = static_cast<T*>(a.chi2) + b * A;
  const T* q = mean + s_blocks[a.q_block].off;
  const T* p = mean + s_blocks[a.p_block].off;
  const T* lever = a.lever_block >= 0 ? mean + s_blocks[a.lever_block].off : s_lever;
  const T* anchors_p = mean + s_blocks[a.ap_block].off;
  const T* anchors_gamma = mean + s_blocks[a.ag_block].off;
  const T* anchors_alpha = mean + s_blocks[a.aa_block].off;

  for (int s = 0; s < A; ++s) {
    // every thread is past the last slot's reads of the block's scalars
    // (`s_go` above all) before thread 0 writes them again
    __syncthreads();
    // ---- the range's residual and H's nonzeros, at the current mean ----
    if (tid == 0) {
      s_go = 0;
      if (!valid[s]) {
        accepted[s] = false;
        chi2[s] = T(0);
      } else {
        const T qx = q[0], qy = q[1], qz = q[2], qw = q[3];
        const T c = T(2) * qw * qw - T(1);
        // R = (2w^2 - 1) I - 2w [qv]x + 2 qv qv^T
        const T R[3][3] = {
            {c + T(2) * qx * qx, T(2) * qw * qz + T(2) * qx * qy, -T(2) * qw * qy + T(2) * qx * qz},
            {-T(2) * qw * qz + T(2) * qy * qx, c + T(2) * qy * qy, T(2) * qw * qx + T(2) * qy * qz},
            {T(2) * qw * qy + T(2) * qz * qx, -T(2) * qw * qx + T(2) * qz * qy, c + T(2) * qz * qz}};
        const T l[3] = {lever[0], lever[1], lever[2]};
        T diff[3];
        for (int i = 0; i < 3; ++i) {
          const T rtl = R[0][i] * l[0] + R[1][i] * l[1] + R[2][i] * l[2];  // (R^T l)_i
          diff[i] = anchors_p[3 * s + i] - (p[i] - rtl);
        }
        const T d = sqrt(diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]);
        const T dn = d < T(1e-9) ? T(1) : d;
        const T u[3] = {diff[0] / dn, diff[1] / dn, diff[2] / dn};
        const T kk = T(1) + anchors_alpha[s];
        s_r = ranges[s] - (kk * d + anchors_gamma[s]);
        // w = R u; dy/dtheta = -(1+a) (w x l), dy/dp = -(1+a) u,
        // dy/dl = (1+a) w, dy/d[p_A, gamma, alpha] = [(1+a) u, 1, d]
        T w[3];
        for (int i = 0; i < 3; ++i) w[i] = R[i][0] * u[0] + R[i][1] * u[1] + R[i][2] * u[2];
        const T wxl[3] = {w[1] * l[2] - w[2] * l[1], w[2] * l[0] - w[0] * l[2], w[0] * l[1] - w[1] * l[0]};
        int n = 0;
        for (int i = 0; i < 3; ++i) {
          s_idx[n] = a.theta_off + i;
          s_h[n++] = -kk * wxl[i];
        }
        for (int i = 0; i < 3; ++i) {
          s_idx[n] = a.p_off + i;
          s_h[n++] = -kk * u[i];
        }
        if (a.lever_off >= 0)
          for (int i = 0; i < 3; ++i) {
            s_idx[n] = a.lever_off + i;
            s_h[n++] = kk * w[i];
          }
        const int a0 = a.anchor_off + 5 * s;
        for (int i = 0; i < 3; ++i) {
          s_idx[n] = a0 + i;
          s_h[n++] = kk * u[i];
        }
        s_idx[n] = a0 + 3;
        s_h[n++] = T(1);
        s_idx[n] = a0 + 4;
        s_h[n++] = d;
        s_nnz = n;
        s_go = 1;
      }
    }
    __syncthreads();
    if (!s_go) continue;

    // ---- P H^T over H's nonzero columns ----
    const int nnz = s_nnz;
    for (int i = tid; i < D; i += kThreads) {
      T acc = T(0);
      for (int k = 0; k < nnz; ++k) acc += P[i * D + s_idx[k]] * s_h[k];
      pht[i] = acc;
    }
    __syncthreads();

    // ---- the gate ----
    if (tid == 0) {
      T S = T(0);
      for (int k = 0; k < nnz; ++k) S += s_h[k] * pht[s_idx[k]];
      S += T(a.sigma2);
      const T r = s_r;
      const T gamma = r * r / S;
      const bool ok = static_cast<double>(gamma) < a.thresh;
      chi2[s] = gamma;
      accepted[s] = ok;
      s_go = ok;
      s_l = S > T(0) ? sqrt(S) : T(NAN);
    }
    __syncthreads();
    if (!s_go) continue;

    // ---- K = P H^T / S, as two divisions by the 1x1 Cholesky factor ----
    const T lf = s_l, r = s_r;
    for (int i = tid; i < D; i += kThreads) kg[i] = pht[i] / lf / lf;
    __syncthreads();

    // ---- P <- sym(P - K (P H^T)^T): pair (i, j <= i) by one thread ----
    for (int i = warp; i < D; i += kThreads / 32) {
      for (int j = lane; j <= i; j += 32) {
        const T x = P[i * D + j] - mul_rn(kg[i], pht[j]);
        const T y = P[j * D + i] - mul_rn(kg[j], pht[i]);
        const T v = T(0.5) * (x + y);
        P[i * D + j] = v;
        P[j * D + i] = v;
      }
    }
    // ---- inject dx = K r: one thread a row of a mean block ----
    INJECT_ROWS(mean, keep, s_blocks, a.table.rows, [&](int e) { return mul_rn(kg[e], r); });
    __syncthreads();
  }

  // ---- write back: the covariance when staged, every mean block ----
  if (kSmem) copy_values(cov_out, P, D * D, [](int i) { return i; });
  store_mean(mean, s_blocks, a.table.mean_len, b);
}

// Whether `a`'s covariance is staged in shared memory (`staged`), and
// whether the kernel of that choice takes `a` at all (the return). The
// dynamic bytes each kernel may take are set once, at the first call,
// which comes before any capture: a graph capture of the kernel follows an
// eager run of the same step.
template <typename T>
cudaError_t choose(const Args& a, bool& staged) {
  static int max_smem = 0, max_global = 0;
  cudaError_t e = opt_in(uwb_update_kernel<T, true>, max_smem);
  if (e == cudaSuccess) e = opt_in(uwb_update_kernel<T, false>, max_global);
  if (e != cudaSuccess) return e;
  staged = smem_bytes<T>(a, true) <= static_cast<size_t>(max_smem);
  return staged || smem_bytes<T>(a, false) <= static_cast<size_t>(max_global) ? cudaSuccess
                                                                              : cudaErrorInvalidValue;
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  bool staged = false;
  const cudaError_t e = choose<T>(a, staged);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t bytes = smem_bytes<T>(a, staged);
  if (staged)
    uwb_update_kernel<T, true><<<batch, kThreads, bytes, stream>>>(a);
  else
    uwb_update_kernel<T, false><<<batch, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// `a` from the int array and, when given, the pointer array; returns
// cudaErrorInvalidValue for a table or shape the kernel does not take.
int parse(const int* ints, const int64_t* ptrs, Args& a) {
  a = Args{};
  a.dim = ints[2];
  a.anchors = ints[3];
  a.theta_off = ints[4];
  a.p_off = ints[5];
  a.lever_off = ints[6];
  a.anchor_off = ints[7];
  a.q_block = ints[8];
  a.p_block = ints[9];
  a.lever_block = ints[10];
  a.ap_block = ints[11];
  a.ag_block = ints[12];
  a.aa_block = ints[13];
  if (ints[1] < 1 || a.dim < 1 || a.anchors < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (ptrs) {
    a.cov_in = reinterpret_cast<const void*>(ptrs[0]);
    a.cov_out = reinterpret_cast<void*>(ptrs[1]);
    a.lever_in = reinterpret_cast<const void*>(ptrs[2]);
    a.ranges = reinterpret_cast<const void*>(ptrs[6]);
    a.range_mask = reinterpret_cast<const bool*>(ptrs[7]);
    a.accepted = reinterpret_cast<bool*>(ptrs[8]);
    a.chi2 = reinterpret_cast<void*>(ptrs[9]);
  }
  return parse_table(ints + 14, ptrs ? ptrs + 3 : nullptr, ptrs ? ptrs + 10 : nullptr, a.table);
}

}  // namespace

// `ints` and `ptrs` as `update/uwb.py` `kernel_ints` / `_launch` lay them out:
//   ints: is_double, batch, dim, anchors, theta_off, p_off, lever_off (-1:
//         not in the error state), anchor_off, the table indices of q, p,
//         the lever arm (-1: read lever_in), anchors_p, anchors_gamma,
//         anchors_alpha, then the table (`parse_table`);
//   ptrs: cov_in, cov_out, lever_in, clones_valid, slam_valid,
//         anchors_valid, ranges, range_mask, accepted, chi2, then per
//         block its input and its output;
//   reals: sigma2, the chi2 threshold.
// Every tensor holds `batch` sequences back to back. The covariance is
// staged in shared memory when it fits (`uvio_uwb_shared_memory`).
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue
// for a table or shape the kernel does not take).
extern "C" int uvio_uwb_update(const int64_t* ptrs, const int* ints, const double* reals, cudaStream_t stream) {
  Args a;
  const int rc = parse(ints, ptrs, a);
  if (rc != 0) return rc;
  a.sigma2 = reals[0];
  a.thresh = reals[1];
  return ints[0] ? launch<double>(a, ints[1], stream) : launch<float>(a, ints[1], stream);
}

// Sets `*staged` to 1 when `uvio_uwb_update` with these `ints` stages the
// covariance in shared memory, 0 when it updates it in global memory.
// Returns what the launch's choice returns: 0 when the kernel takes the
// shape.
extern "C" int uvio_uwb_shared_memory(const int* ints, int* staged) {
  Args a;
  int rc = parse(ints, nullptr, a);
  if (rc != 0) return rc;
  bool s = false;
  rc = static_cast<int>(ints[0] ? choose<double>(a, s) : choose<float>(a, s));
  *staged = s;
  return rc;
}
