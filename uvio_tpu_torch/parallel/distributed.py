"""Multi-process scaffolding: `torch.distributed` launch, the BA meshes,
and the bundle adjustment's communication table.

Port of `uvio_tpu/parallel/distributed.py`. `uvio_tpu` builds JAX device
meshes for `shard_map`; here one process drives one device, and a mesh is
a grid of process ranks with one process group per grid row and column:

* `init_from_env()`: `torch.distributed.init_process_group` from the
  `UVIO_*` variables, a no-op returning False without them, so every
  entry point can call it unconditionally (NCCL when the process sees a
  CUDA device, gloo otherwise).
* `make_ba_mesh(n_kf_shards)`: the ("kf", "lm") grid for the 2-D Schur BA
  (`parallel/ba.py`), ranks laid out row-major as `uvio_tpu`'s
  `devices.reshape(kf, lm)`; `make_lm_mesh()`: the 1-D ("lm",) mesh of
  landmark sharding over every rank.
* `comm_volume_table(...)` / `print_comm_table(...)`: the analytic
  per-phase bytes-moved / flops table of one BA iteration, unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

_ENV_COORD = "UVIO_COORDINATOR"  # e.g. "127.0.0.1:6780"
_ENV_NPROC = "UVIO_NUM_PROCESSES"
_ENV_PID = "UVIO_PROCESS_ID"


def init_from_env() -> bool:
    """Initialize `torch.distributed` from env vars; return whether a
    multi-process runtime is active.

        UVIO_COORDINATOR   = "<addr>:<port>" of process 0
        UVIO_NUM_PROCESSES = total process count
        UVIO_PROCESS_ID    = this process's index [0, N)

    Without all three set this is a no-op (single process). With a CUDA
    device the backend is NCCL and the process takes device
    `rank % device_count`; on the CPU it is gloo.
    """
    coord = os.environ.get(_ENV_COORD)
    nproc = os.environ.get(_ENV_NPROC)
    pid = os.environ.get(_ENV_PID)
    if not (coord and nproc and pid):
        return False
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "nccl"
        torch.cuda.set_device(int(pid) % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}", world_size=int(nproc), rank=int(pid)
    )
    return True


class BAMesh:
    """A (kf x lm) grid of the ranks of the default process group.

    Rank r sits at (r // lm, r % lm). `group("lm")` holds the ranks of r's
    grid row (its "lm" axis: the landmark shards), `group("kf")` those of
    its column, `group("all")` every rank. Every rank must build the mesh
    (creating a process group is collective)."""

    def __init__(self, axis_names, kf: int, lm: int):
        import torch.distributed as dist

        world, rank = dist.get_world_size(), dist.get_rank()
        if kf * lm != world:
            raise ValueError(f"mesh kf={kf} x lm={lm} needs {kf * lm} processes, not {world}")
        self.axis_names = tuple(axis_names)
        self._size = {"kf": kf, "lm": lm}
        self._index = {"kf": rank // lm, "lm": rank % lm}
        self._groups = {"all": dist.group.WORLD}
        # every rank creates every group, in the same order
        for i in range(kf):
            g = dist.new_group([i * lm + j for j in range(lm)])
            if i == self._index["kf"]:
                self._groups["lm"] = g
        for j in range(lm):
            g = dist.new_group([i * lm + j for i in range(kf)])
            if j == self._index["lm"]:
                self._groups["kf"] = g

    def size(self, axis: str) -> int:
        return self._size[axis]

    def index(self, axis: str) -> int:
        return self._index[axis]

    def group(self, name: str):
        return self._groups[name]

    @property
    def shape(self):
        return tuple(self._size[a] for a in self.axis_names)


def make_ba_mesh(n_kf_shards: Optional[int] = None) -> BAMesh:
    """The ("kf", "lm") mesh over the ranks of the initialized default
    process group: kf = `n_kf_shards` (default 2 when the world size is
    even, else 1), lm = the rest. The "lm" axis carries the big per-
    iteration all-reduce of the 6Nx6N reduced camera system, so on a
    multi-host cluster keep a grid row within one host."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if n_kf_shards is None:
        n_kf_shards = 2 if n % 2 == 0 else 1
    assert n % n_kf_shards == 0, (n, n_kf_shards)
    return BAMesh(("kf", "lm"), n_kf_shards, n // n_kf_shards)


def make_lm_mesh() -> BAMesh:
    """The 1-D ("lm",) mesh: landmark sharding over every rank."""
    import torch.distributed as dist

    return BAMesh(("lm",), 1, dist.get_world_size())


@dataclass
class CommRow:
    phase: str
    axis: str
    bytes_moved: float  # per device per iteration
    flops: float  # per device per iteration (0 for pure collectives)


def comm_volume_table(N: int, L: int, pk: int, pl: int, dtype_bytes: int = 8):
    """Per-iteration communication vs compute for the 2D Schur BA.

    N keyframes, L landmarks, mesh (kf=pk, lm=pl). Ring-collective cost
    model: all-reduce moves 2(p-1)/p of the payload per device;
    all-gather moves (p-1)/p of the GATHERED size per device.

    Returns a list of CommRow, one per phase of the iteration.
    """
    rows = []
    Nl = N / pk  # keyframes per kf shard
    Ll = L / pl  # landmarks per lm shard

    # local residual/Jacobian + per-landmark Hessian build: per (lm, kf)
    # observation ~ 300 flops (2x6 + 2x3 jacobians, Huber, products)
    rows.append(CommRow("jacobians+hessians (local)", "-", 0.0, Ll * Nl * 300.0))
    # all-reduce over kf of per-landmark A (3x3) and b_l (3)
    vol = Ll * 12 * dtype_bytes * 2 * (pk - 1) / max(pk, 1)
    rows.append(CommRow("psum per-landmark A,b_l", "kf", vol, 0.0))
    # all-gather over kf of Hpl (Ll, N, 3, 6), Hpp_diag (N,6,6), b_p (N,6)
    gathered = (Ll * N * 18 + N * 36 + N * 6) * dtype_bytes
    rows.append(CommRow("all-gather pose blocks", "kf", gathered * (pk - 1) / max(pk, 1), 0.0))
    # local Schur: S_l = sum_l B A^-1 B^T  ->  Ll * (6N)^2-ish products
    rows.append(CommRow("schur reduce (local)", "-", 0.0, Ll * (6 * N) ** 2 * 2.0 / N))
    # all-reduce over lm of S (6N x 6N) + b (6N)
    vol = ((6 * N) ** 2 + 6 * N) * dtype_bytes * 2 * (pl - 1) / max(pl, 1)
    rows.append(CommRow("psum reduced camera system", "lm", vol, 0.0))
    # replicated solve (every device): chol of 6N
    rows.append(CommRow("camera solve (replicated)", "-", 0.0, (6 * N) ** 3 / 3.0))
    # landmark back-substitution (local)
    rows.append(CommRow("landmark backsub (local)", "-", 0.0, Ll * N * 40.0))
    return rows


def print_comm_table(N: int, L: int, pk: int, pl: int, dtype_bytes: int = 8):
    rows = comm_volume_table(N, L, pk, pl, dtype_bytes)
    print(f"BA comm/compute per iteration — N={N} kf, L={L} lm, mesh kf={pk} x lm={pl}")
    print(f"{'phase':<34}{'axis':<6}{'MB/device':>12}{'GFLOP/device':>14}")
    for r in rows:
        print(f"{r.phase:<34}{r.axis:<6}{r.bytes_moved / 1e6:>12.3f}{r.flops / 1e9:>14.4f}")
    tot_b = sum(r.bytes_moved for r in rows)
    tot_f = sum(r.flops for r in rows)
    print(f"{'TOTAL':<34}{'':<6}{tot_b / 1e6:>12.3f}{tot_f / 1e9:>14.4f}")
    return rows
