"""A NumPy model of what the filter kernels share (`csrc/mean_table.cuh`):
their host arrays, their table of mean blocks and the injection of a
correction into the blocks. The CPU tests of `update/uwb.py` and
`update/slam.py` build their models of the C entry points on it.

Imports neither JAX nor `uvio_tpu`, nor anything pytest collects.
"""

import ctypes

import numpy as np


def view(ptr, n, dtype):
    """The n values of `dtype` at host address `ptr`, writable."""
    if n == 0:
        return np.zeros(0, dtype)
    return np.frombuffer((ctypes.c_char * (n * np.dtype(dtype).itemsize)).from_address(ptr), dtype, n)


def reader(ptrs):
    """`nxt(n, dtype)`: the next pointer of the array `ptrs` as a view of
    n values of `dtype`, in the array's order."""
    it = iter(ptrs)
    return lambda n, dtype: view(next(it), n, dtype)


def table(ints):
    """The blocks of a table's ints (`filter.ekf.table_ints`: the number of
    blocks, then six ints a block), each (quat, rows, width, err_off,
    err_stride, mask)."""
    return [tuple(ints[1 + 6 * k: 7 + 6 * k]) for k in range(ints[0])]


def masks(nxt, B, blocks):
    """The next three pointers as the masks of `MASKS`, (B, rows) each
    (no rows where no block names one)."""
    rows = {m: r for _, r, _, _, _, m in blocks if m >= 0}
    return [nxt(B * rows.get(m, 0), np.bool_).reshape(B, -1) for m in range(3)]


def mean_blocks(nxt, B, blocks, T):
    """The next pointer pairs as each block's input and output, (B, rows *
    width) each; the outputs start as the inputs, as the kernels write
    every block back."""
    outs = []
    for _, rows, width, _, _, _ in blocks:
        inp = nxt(B * rows * width, T).reshape(B, -1)
        out = nxt(B * rows * width, T).reshape(B, -1)
        out[:] = inp
        outs.append(out)
    return outs


def keep(masks, b, blocks):
    """Sequence b's rows an update may change, a bool array a block."""
    return [masks[m][b].copy() if m >= 0 else np.ones(rows, bool) for _, rows, _, _, _, m in blocks]


def inject(outs, b, blocks, keep, dx):
    """dx injected into sequence b's blocks: quaternion rows by the error
    quaternion's product, the rest added, rows not kept left alone."""
    for k, (quat, rows, width, err_off, err_stride, _) in enumerate(blocks):
        x = outs[k][b].reshape(rows, width)
        for row in range(rows):
            if not keep[k][row]:
                continue
            e = dx[err_off + row * err_stride: err_off + row * err_stride + (3 if quat else width)]
            if quat:
                dq = np.array([*(e / 2), 1], x.dtype)
                dq /= np.linalg.norm(dq)
                dq = -dq if dq[3] < 0 else dq
                pv, pw = x[row, :3].copy(), x[row, 3]
                new = np.array([*(dq[3] * pv + pw * dq[:3] - np.cross(dq[:3], pv)), dq[3] * pw - dq[:3] @ pv],
                               x.dtype)
                new /= np.linalg.norm(new)
                x[row] = -new if new[3] < 0 else new
            else:
                x[row] += e
