"""Port parity, triangulation options: `triangulate_1d` and
`triangulate_batch(refine=, use_1d=)` against `uvio_tpu`'s, float64 on
the CPU.

Tolerances: the same closed forms and the same five Gauss-Newton steps in
both packages, so points agree to 1e-10 and every `ok` flag exactly. The
port's functions are batched over a leading feature axis where
`uvio_tpu`'s `triangulate_1d` takes one feature; the single-feature
inputs gain that axis.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from uvio_tpu.update.triangulation import triangulate_1d as j_tri1d
from uvio_tpu.update.triangulation import triangulate_batch as j_batch

from uvio_tpu_torch.update.triangulation import triangulate_1d as t_tri1d
from uvio_tpu_torch.update.triangulation import triangulate_batch as t_batch

T64 = torch.float64


def _t(a, dtype=T64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _aux_inputs():
    """The inputs of `tests/test_aux.py::test_triangulate_1d`."""
    rng = np.random.default_rng(1)
    p_true = np.array([0.5, -0.3, 4.0])
    M = 6
    p_C = np.concatenate([rng.uniform(-1, 1, (M, 2)), np.zeros((M, 1))], axis=1)
    R = np.tile(np.eye(3), (M, 1, 1))
    rel = p_true[None] - p_C
    return p_true, rel[:, :2] / rel[:, 2:3], R, p_C


@pytest.mark.parametrize("case", ["all", "single_obs", "none", "first_two"])
def test_triangulate_1d_on_the_reference_inputs(case):
    p_true, uvn, R, p_C = _aux_inputs()
    mask = np.ones(6, bool)
    if case == "single_obs":
        mask[:] = False
        mask[0] = True
    elif case == "none":
        mask[:] = False
    elif case == "first_two":
        mask[2:] = False
    jp, jok = j_tri1d(jnp.asarray(uvn), jnp.asarray(mask), jnp.asarray(R), jnp.asarray(p_C))
    tp, tok = t_tri1d(_t(uvn)[None], _t(mask, torch.bool)[None], _t(R)[None], _t(p_C)[None])
    assert bool(tok[0]) == bool(jok) == (case in ("all", "first_two"))
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp), rtol=0, atol=1e-10)
    if case == "all":
        assert np.linalg.norm(tp[0].numpy() - p_true) < 1e-6


def _random_batch(seed, F=48, M=8):
    """F points seen by M cameras spread on a 1.5 m patch, looking along
    +z with small random tilts; masks drop observations at random (some
    features keep one observation or none)."""
    rng = np.random.default_rng(seed)
    R = Rotation.from_rotvec(0.05 * rng.standard_normal((M, 3))).as_matrix()  # R_GtoC
    p_C = np.concatenate([rng.uniform(-0.75, 0.75, (M, 2)), rng.uniform(-0.2, 0.2, (M, 1))], axis=1)
    pts = np.concatenate([rng.uniform(-2, 2, (F, 2)), rng.uniform(2, 9, (F, 1))], axis=1)
    pc = np.einsum("mij,fmj->fmi", R, pts[:, None, :] - p_C[None])
    uvn = pc[..., :2] / pc[..., 2:3] + 1e-3 * rng.standard_normal((F, M, 2))
    mask = rng.random((F, M)) < 0.7
    mask[:4] = False
    mask[0, 3] = True  # one observation
    mask[2, [0, M - 1]] = True  # two, at the window's ends
    return uvn, mask, R, p_C


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("use_1d", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_batch_options_match(refine, use_1d, seed):
    uvn, mask, R, p_C = _random_batch(seed)
    # the shared (M,...) poses, and per-feature (F,M,...) ones
    for Rg, pg in ((R, p_C), (np.broadcast_to(R, (len(uvn),) + R.shape), np.broadcast_to(p_C, (len(uvn),) + p_C.shape))):
        jp, jok = j_batch(jnp.asarray(uvn), jnp.asarray(mask), jnp.asarray(Rg), jnp.asarray(pg),
                          refine=refine, use_1d=use_1d)
        tp, tok = t_batch(_t(uvn), _t(mask, torch.bool), _t(Rg), _t(pg), refine=refine, use_1d=use_1d)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-10)
    assert 20 <= int(tok.sum()) < len(uvn)  # most triangulate, the degenerate rows do not


def test_default_batch_is_the_refined_linear_solve():
    """The callers' call (no options) is `refine=True, use_1d=False`, bit
    for bit."""
    uvn, mask, R, p_C = _random_batch(2)
    a = t_batch(_t(uvn), _t(mask, torch.bool), _t(R), _t(p_C))
    b = t_batch(_t(uvn), _t(mask, torch.bool), _t(R), _t(p_C), refine=True, max_baseline=40.0, use_1d=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
