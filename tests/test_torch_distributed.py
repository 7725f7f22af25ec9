"""The sharded bundle adjustment over `torch.distributed` (gloo on the
CPU) against the port's one-device solve, and the plain-Python pieces of
`parallel/distributed.py` against `uvio_tpu`'s.

Each sharded case spawns its processes, which meet through a `file://`
store under the test's `tmp_path` (no TCP port, so parallel test workers
cannot collide), solve `tests/test_ba.py`'s scene (N=12, L=64, 8
iterations) and write their results; the parent compares them.

Tolerances: the sharded solves differ from the one-device solve only in
the order of their sums, so costs and final parameters agree to 1e-10
(relative for the costs); every rank returns the same full result, bit
for bit.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from uvio_tpu_torch.parallel.ba import BAOptions, ba_solve

ITERS = 8


def _worker(rank, world, store, mode, n_kf, scene, out_dir):
    """One process of the sharded solve (module level, so `spawn` can
    import it)."""
    import torch.distributed as dist

    from uvio_tpu_torch.parallel.distributed import make_ba_mesh, make_lm_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = make_lm_mesh() if mode == "1d" else make_ba_mesh(n_kf)
        extra = {"shape": np.asarray(mesh.shape), "index": np.asarray([mesh.index("kf"), mesh.index("lm")])}
        if mode == "2d":
            extra["default_shape"] = np.asarray(make_ba_mesh().shape)
            extra["kf1_shape"] = np.asarray(make_ba_mesh(1).shape)
        d = np.load(scene)
        t = lambda k, dtype=torch.float64: torch.as_tensor(d[k], dtype=dtype)
        q, p, lm, info = ba_solve(t("q0"), t("p0"), t("lm0"), t("obs"), t("mask", torch.bool),
                                  BAOptions(iters=ITERS), mesh=mesh)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), q=q.numpy(), p=p.numpy(), lm=lm.numpy(),
                 costs=info["costs"].numpy(), **extra)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """`tests/test_ba.py`'s scene, perturbed, and the one-device solve."""
    from tests.test_ba import make_scene, perturb

    q, p, lm, obs, mask = make_scene(N=12, L=64)
    q0, p0, lm0 = perturb(q, p, lm)
    path = tmp_path_factory.mktemp("scene") / "scene.npz"
    np.savez(path, q0=q0, p0=p0, lm0=lm0, obs=obs, mask=mask)
    t = lambda a, dtype=torch.float64: torch.as_tensor(a, dtype=dtype)
    torch.set_num_threads(1)
    q1, p1, lm1, info = ba_solve(t(q0), t(p0), t(lm0), t(obs), t(mask, torch.bool), BAOptions(iters=ITERS))
    return str(path), {"q": q1.numpy(), "p": p1.numpy(), "lm": lm1.numpy(), "costs": info["costs"].numpy()}


@pytest.mark.parametrize("mode,world,n_kf", [("1d", 2, 1), ("2d", 4, 2)], ids=["1d-lm2", "2d-kf2xlm2"])
def test_sharded_ba_matches_one_device(scene, tmp_path, mode, world, n_kf):
    path, ref = scene
    mp.spawn(_worker, args=(world, str(tmp_path / "store"), mode, n_kf, path, str(tmp_path)),
             nprocs=world, join=True)
    outs = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    for r, o in enumerate(outs):
        for k in ("q", "p", "lm", "costs"):
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=f"rank {r} {k}")
        assert tuple(o["index"]) == (r // (world // n_kf), r % (world // n_kf))
    o = outs[0]
    np.testing.assert_allclose(o["costs"], ref["costs"], rtol=1e-10, atol=0)
    for k in ("q", "p", "lm"):
        np.testing.assert_allclose(o[k], ref[k], rtol=0, atol=1e-10, err_msg=k)
    assert ref["costs"][-1] < 0.05 * ref["costs"][0]
    if mode == "1d":
        assert tuple(o["shape"]) == (2,)
    else:
        assert tuple(o["shape"]) == (2, 2) and tuple(o["default_shape"]) == (2, 2)
        assert tuple(o["kf1_shape"]) == (1, 4)


def test_comm_volume_table_matches_reference():
    from uvio_tpu.parallel.distributed import comm_volume_table as j_table

    from uvio_tpu_torch.parallel.distributed import comm_volume_table, print_comm_table

    for args in ((256, 4096, 2, 4), (256, 4096, 2, 8), (256, 4096, 1, 1), (64, 4096, 1, 1), (48, 640, 2, 2)):
        got = [(r.phase, r.axis, r.bytes_moved, r.flops) for r in comm_volume_table(*args)]
        assert got == [(r.phase, r.axis, r.bytes_moved, r.flops) for r in j_table(*args)], args
    rows = print_comm_table(256, 4096, 2, 4)
    by = {r.phase: r for r in rows}
    assert by["psum reduced camera system"].axis == "lm"
    assert by["psum reduced camera system"].bytes_moved > by["psum per-landmark A,b_l"].bytes_moved
    assert sum(r.bytes_moved for r in comm_volume_table(256, 4096, 1, 1)) == 0.0


def test_init_from_env_noop_without_vars(monkeypatch):
    from uvio_tpu_torch.parallel import distributed as D

    for k in ("UVIO_COORDINATOR", "UVIO_NUM_PROCESSES", "UVIO_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert D.init_from_env() is False
    monkeypatch.setenv("UVIO_COORDINATOR", "127.0.0.1:1")  # incomplete: still a no-op
    assert D.init_from_env() is False
