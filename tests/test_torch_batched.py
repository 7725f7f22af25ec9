"""Port parity, the batch plumbing of `pipeline.py`: `make_batched_step`
(`filter_step` over a sequence-batch axis) against `uvio_tpu`'s and
against the port's own single-sequence step row by row, and
`HostPipeline`'s ordering, content and overlap (the cases of
`tests/test_pipeline.py`), float64 on the CPU.

Tolerances: the batched state agrees with `uvio_tpu`'s batched step to
1e-8 and with the port's per-sequence `make_step` to 1e-10 (the same
arithmetic, batched); the MSCKF decisions are equal. The pipeline's
staged chunks are bit-equal copies.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvio_tpu_torch.fixtures import load_full_step_fixture
from uvio_tpu_torch.pipeline import HostPipeline
from uvio_tpu_torch.types.state import FIELDS, FilterState, state_from_numpy, state_to_numpy

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
T64 = torch.float64
INPUTS = ("imu_t", "imu_w", "imu_a", "msckf_uv", "msckf_mask")
MSCKF_KEYS = ("tri_ok", "kept", "num_used", "cov_ok")


def _sequences(fx):
    """Three sequences of two frames (the fixture's frames 0 and 1): from
    its state0, from state0 with a full clone ring (so the step
    marginalizes first), and from state0 moved by 2 cm with a third of
    the features dropped."""
    s0 = dict(fx.state0)
    full = dict(s0)
    free = ~full["clones_valid"]
    full["clones_valid"] = np.ones_like(free)
    full["clones_t"] = np.where(free, full["clones_t"][~free].min() - 0.1, full["clones_t"])
    moved = dict(s0, p=s0["p"] + 0.02, p_fej=s0["p_fej"] + 0.02)
    states = [s0, full, moved]
    frames = []
    for k in (0, 1):
        rows = []
        for b in range(3):
            args = [np.array(fx.bundles[k][n]) for n in INPUTS]
            if b == 2:
                args[4][::3] = False
            rows.append(args)
        frames.append([np.stack([r[i] for r in rows]) for i in range(len(INPUTS))])
    return states, frames


def _cfgs(fx):
    from uvio_tpu.filter.propagator import NoiseManager as JN
    from uvio_tpu.pipeline import StepConfig as JStepConfig
    from uvio_tpu.types import StateLayout as JL

    from uvio_tpu_torch.filter.propagator import NoiseManager as TN
    from uvio_tpu_torch.pipeline import StepConfig
    from uvio_tpu_torch.types import StateLayout as TL

    c = fx.config
    return (JStepConfig(layout=JL(**c["layout"]), noises=JN(**c["noises"]), sigma_pix=c["sigma_pix"]),
            StepConfig(layout=TL(**c["layout"]), noises=TN(**c["noises"]), sigma_pix=c["sigma_pix"]))


def test_batched_step_matches_reference_and_rows():
    from uvio_tpu.pipeline import make_batched_step as j_make
    from uvio_tpu.types.state import FilterState as JState

    from uvio_tpu_torch.pipeline import make_batched_step, make_step

    fx = load_full_step_fixture()
    jcfg, tcfg = _cfgs(fx)
    states, frames = _sequences(fx)
    stacked = {n: np.stack([s[n] for s in states]) for n in FIELDS}
    js = JState(**{n: jnp.asarray(stacked[n]) for n in FIELDS})
    rows = [state_from_numpy(s, device="cpu", dtype=T64) for s in states]
    ts = FilterState(**{n: torch.stack([getattr(r, n) for r in rows]) for n in FIELDS})
    jstep, tstep, single = j_make(jcfg), make_batched_step(tcfg), make_step(tcfg)
    used = 0
    for k, args in enumerate(frames):
        js, ji = jstep(js, *map(jnp.asarray, args))
        ts, ti = tstep(ts, *(torch.as_tensor(a) for a in args))
        got, ref = state_to_numpy(ts), {n: np.asarray(getattr(js, n)) for n in FIELDS}
        for n in FIELDS:
            if ref[n].dtype == bool or np.issubdtype(ref[n].dtype, np.integer):
                np.testing.assert_array_equal(got[n], ref[n], err_msg=f"frame {k} {n}")
            else:
                np.testing.assert_allclose(got[n], ref[n], rtol=0, atol=1e-8, err_msg=f"frame {k} {n}")
        for key in MSCKF_KEYS:
            np.testing.assert_array_equal(ti[key].numpy(), np.asarray(ji[key]), err_msg=f"frame {k} {key}")
        for b in range(3):
            rows[b], ri = single(rows[b], *(torch.as_tensor(a[b]) for a in args))
            one = state_to_numpy(rows[b])
            for n in FIELDS:
                np.testing.assert_allclose(got[n][b], one[n], rtol=0, atol=1e-10, err_msg=f"frame {k} row {b} {n}")
            assert int(ri["num_used"]) == int(ti["num_used"][b])
        used += int(ti["num_used"].sum())
    assert used > 0
    assert np.abs(np.asarray(js.p[0]) - np.asarray(js.p[2])).max() > 1e-3  # the rows are different sequences


def test_host_pipeline_order_and_content():
    chunks = [{"a": np.full((4,), i, np.float32), "b": np.arange(i, i + 3)} for i in range(7)]
    out = list(HostPipeline(iter(chunks), device="cpu", depth=2))
    assert len(out) == 7
    for i, c in enumerate(out):
        assert isinstance(c["a"], torch.Tensor) and c["a"].dtype == torch.float32
        np.testing.assert_array_equal(c["a"].numpy(), np.full((4,), i, np.float32))
        np.testing.assert_array_equal(c["b"].numpy(), np.arange(i, i + 3))


def test_host_pipeline_overlaps_consumer():
    """The producer keeps staging while the consumer is slow."""

    def slow_chunks():
        for i in range(4):
            yield np.full((2,), i, np.float32)

    pipe = HostPipeline(slow_chunks(), device="cpu", depth=2)
    it = iter(pipe)
    first = next(it)
    time.sleep(0.05)  # the producer should have prefetched the next chunks
    assert pipe._q.qsize() >= 1
    rest = list(it)
    assert len(rest) == 3
    np.testing.assert_array_equal(first.numpy(), [0, 0])


def test_host_pipeline_nested_chunks_are_copies():
    """Named tuples, lists, tensors and numbers pass through; every leaf
    is a new tensor (writing the source afterwards changes nothing)."""
    from uvio_tpu_torch.pipeline import FramePlan

    src = torch.arange(6.0)
    chunk = {"plan": FramePlan(True, (False, True), False, True), "xs": [src, np.eye(2)], "n": 3}
    (out,) = list(HostPipeline([chunk], device="cpu"))
    src += 100.0
    assert isinstance(out["plan"], FramePlan) and bool(out["plan"].zupt_try) and out["plan"].uwb_rows[1].item()
    np.testing.assert_array_equal(out["xs"][0].numpy(), np.arange(6.0))
    np.testing.assert_array_equal(out["xs"][1].numpy(), np.eye(2))
    assert int(out["n"]) == 3


def test_host_pipeline_device_none_is_the_card_or_an_error():
    if torch.cuda.is_available():
        pytest.skip("covered on the card by tests/test_torch_manager_cuda.py")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HostPipeline(iter([]))
