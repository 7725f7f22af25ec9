"""What the CPU can hold of the CUDA kernels' design: the slab geometry
of the Lucas-Kanade kernel (a plain variant that reads img_next through
per-feature slabs, bitwise equal to `lk_level_ref`), the level loop
(`lk_track_ref` against `uvio_tpu`'s `klt.lk_track`), the FAST-9 compass
pretest as a plain function (necessary for a positive score), the
constants and entry points of the CUDA sources, and the rule that the
port's entry points run on the card unless given `device="cpu"`.

The kernels themselves run only on the card: `test_torch_kernels_cuda.py`
and `chip_smoke.py` hold them against these plain versions there."""

import ctypes
import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from uvio_tpu.frontend import klt as JK

import uvio_tpu_torch
from uvio_tpu_torch import _build
from uvio_tpu_torch.frontend import kernels as TKer
from uvio_tpu_torch.frontend import klt as TK
from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(_build.__file__), "csrc")


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _src(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _scene(seed, H, W, N, shift):
    """A smooth random texture, a copy shifted by `shift` = (dx, dy) px,
    and N feature positions at least 20 px inside."""
    from scipy.signal import convolve2d

    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (H // 4 + 4, W // 4 + 4))
    img1 = convolve2d(np.kron(base, np.ones((4, 4)))[:H, :W], np.ones((3, 3)) / 9, mode="same")
    img2 = np.roll(img1, (shift[1], shift[0]), axis=(0, 1))
    uv = np.stack([rng.uniform(20, W - 20, N), rng.uniform(20, H - 20, N)], 1)
    return img1.astype(np.float32), img2.astype(np.float32), uv.astype(np.float32)


# ---------------------------------------------------------------------------
# Lucas-Kanade: the slab
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("half,n", [(7, 480), (7, 60), (7, 20), (3, 94), (0, 2), (5, 29)])
def test_slab_holds_the_window_it_was_staged_around(half, n):
    P = 2 * half + 1
    ext = TKer.slab_extent(half, n)
    assert ext == min(P + 1 + 2 * TKer.LK_SLAB_MARGIN, n)
    w0 = torch.arange(0, n - P)  # every clipped window start of the axis
    org = TKer.slab_origin(w0, ext, n)
    assert (org >= 0).all() and (org + ext <= n).all()
    assert TKer.slab_contains(w0, org, ext, half).all()
    # the margin is kept on both sides wherever the image allows it
    free = (w0 >= TKer.LK_SLAB_MARGIN) & (w0 + P + 1 + TKer.LK_SLAB_MARGIN <= n)
    assert (org[free] == w0[free] - TKer.LK_SLAB_MARGIN).all()
    # and a window one pixel past either side is reported outside
    assert not TKer.slab_contains(org - 1, org, ext, half).any()
    assert not TKer.slab_contains(org + ext - P, org, ext, half).any()


def _slab_case(name):
    """(img1, img2, uv_prev, uv_guess, valid, kwargs, min stagings of
    the feature that moves most)."""
    if name == "inside":  # small motion: one staging per feature
        img1, img2, uv = _scene(0, 120, 160, 32, (2, -1))
        return img1, img2, uv, uv.copy(), np.ones(32, bool), {}, 1
    if name == "leaves_slab":  # a smooth scene, the guess 12 px off on 10 features
        from scipy.ndimage import gaussian_filter

        rng = np.random.default_rng(1)
        img1 = gaussian_filter(rng.uniform(0, 255, (160, 200)), 6.0)
        img1 = ((img1 - img1.min()) / (img1.max() - img1.min()) * 255).astype(np.float32)
        img2 = np.roll(img1, (-1, 2), axis=(0, 1))
        uv = np.stack([rng.uniform(40, 160, 32), rng.uniform(40, 120, 32)], 1).astype(np.float32)
        guess = uv.copy()
        guess[:10] += np.array([12.0, -12.0], np.float32)
        return img1, img2, uv, guess, np.ones(32, bool), {}, 1
    if name == "border":  # windows clipped at every image edge, one invalid
        img1, img2, uv = _scene(2, 120, 160, 32, (1, 1))
        uv[0], uv[1], uv[2], uv[3] = (2.0, 2.0), (157.0, 117.0), (80.0, 1.5), (158.5, 60.0)
        valid = np.ones(32, bool)
        valid[4] = False
        return img1, img2, uv, uv.copy(), valid, {}, 1
    if name == "small_image":  # an image smaller than the slab
        img1, img2, uv = _scene(3, 48, 64, 8, (1, 0))
        sl = np.s_[:26, :30]
        uv = np.clip(uv, 9, 18).astype(np.float32)
        return (np.ascontiguousarray(img1[sl]), np.ascontiguousarray(img2[sl]), uv, uv.copy(),
                np.ones(8, bool), {}, 1)
    if name == "half3_coarse":  # a narrower patch, the coarse-level settings
        img1, img2, uv = _scene(4, 120, 160, 32, (3, 2))
        return img1, img2, uv, uv.copy(), np.ones(32, bool), dict(half=3, iters=6, min_eig=0.0), 1
    raise KeyError(name)


@pytest.mark.parametrize("name", ["inside", "leaves_slab", "border", "small_image", "half3_coarse"])
def test_lk_slab_variant_is_bitwise_lk_level_ref(name):
    img1, img2, uv, guess, valid, kw, _ = _slab_case(name)
    args = (_t(img1), _t(img2), _t(uv), _t(guess), _t(valid, torch.bool))
    uv_r, ok_r = TKer.lk_level_ref(*args, **kw)
    uv_s, ok_s, stagings = TKer.lk_level_slab_ref(*args, **kw)
    assert torch.equal(uv_r, uv_s) and torch.equal(ok_r, ok_s)
    assert (stagings >= 1).all()
    if name == "leaves_slab":
        # on smooth ground a far guess travels further than the margin:
        # those features stage again, the others do not
        assert (stagings[:10] >= 2).sum() >= 5
        assert (stagings[10:] == 1).all()
    if name == "inside":
        assert (stagings == 1).all() and ok_r.sum() >= 24
    if name == "border":
        assert not ok_r[:5].any() and ok_r.sum() >= 16


def test_lk_level_ref_records_its_windows():
    img1, img2, uv, guess, valid, _, _ = _slab_case("inside")
    wins = []
    args = (_t(img1), _t(img2), _t(uv), _t(guess), _t(valid, torch.bool))
    uv_a, ok_a = TKer.lk_level_ref(*args, iters=5, windows=wins)
    uv_b, ok_b = TKer.lk_level_ref(*args, iters=5)
    assert torch.equal(uv_a, uv_b) and torch.equal(ok_a, ok_b)
    assert len(wins) == 5 and all(x.shape == (32,) and y.shape == (32,) for x, y in wins)
    x0, y0 = wins[0]
    assert torch.equal(x0, torch.floor(_t(guess)[:, 0]).long() - 7)


# ---------------------------------------------------------------------------
# Lucas-Kanade: the level loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("levels,kw", [
    (4, {}), (3, dict(iters=8, coarse_iters=3)), (1, dict(iters=10)), (2, dict(half=5, coarse_iters=12)),
])
def test_lk_track_ref_matches_jax(levels, kw):
    img1, img2, uv = _scene(5, 240, 320, 48, (5, -3) if levels > 1 else (1, -1))
    valid = np.ones(len(uv), bool)
    valid[::7] = False
    pj = [JK.build_pyramid(jnp.asarray(im), levels) for im in (img1, img2)]
    pt = [TK.build_pyramid(_t(im), levels) for im in (img1, img2)]
    uv_j, ok_j = JK.lk_track(pj[0], pj[1], jnp.asarray(uv), jnp.asarray(valid), **kw)
    before = dict(TKer.launch_counts)
    uv_t, ok_t = TKer.lk_track(pt[0], pt[1], _t(uv), _t(valid, torch.bool), **kw)
    assert TKer.launch_counts == before  # CPU tensors: the plain version, no launch
    uv_j, ok_j = np.asarray(uv_j), np.asarray(ok_j)
    # masks equal; positions to float32 rounding of the 225-term sums
    assert (ok_j == ok_t.numpy()).all() and ok_j.sum() >= 30
    assert np.abs(uv_j[ok_j] - uv_t.numpy()[ok_j]).max() < 1e-3


def test_lk_track_ref_is_the_chain_of_levels_through_slabs():
    """The level loop with the slab-reading level function: what one
    fused launch computes, level by level, bitwise the plain chain."""
    img1, img2, uv = _scene(6, 240, 320, 40, (5, -3))
    valid = _t(np.ones(len(uv), bool), torch.bool)
    p1, p2 = (TK.build_pyramid(_t(im), 4) for im in (img1, img2))
    staged = []

    def slab_level(*args):
        uv_l, ok_l, n = TKer.lk_level_slab_ref(*args)
        staged.append(n)
        return uv_l, ok_l

    uv_a, ok_a = TKer.lk_track_ref(p1, p2, _t(uv), valid)
    uv_b, ok_b = TKer.lk_track_ref(p1, p2, _t(uv), valid, level_fn=slab_level)
    assert torch.equal(uv_a, uv_b) and torch.equal(ok_a, ok_b)
    assert len(staged) == 4 and ok_a.sum() >= 25
    flow = (uv_a - _t(uv))[ok_a].median(0).values
    np.testing.assert_allclose(flow.numpy(), [5.0, -3.0], atol=0.1)


def test_lk_wrappers_refuse_what_the_kernel_does_not_take():
    img = torch.zeros((40, 40), device="meta")
    uv = torch.zeros((4, 2), device="meta")
    ok = torch.zeros(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):  # neither CPU nor CUDA
        TKer.lk_track([img], [img], uv, ok)
    with pytest.raises(ValueError):  # tensors on two devices
        TKer.lk_track([img], [torch.zeros((40, 40))], uv, ok)
    with pytest.raises(ValueError):
        TKer._check_half(8)
    with pytest.raises(ValueError):  # a level smaller than the window block
        TKer._check_level("pyr[3]", torch.zeros((12, 40)), torch.zeros((12, 40)), 7)
    with pytest.raises(TypeError):
        TKer._check_level("pyr[0]", torch.zeros((40, 40), dtype=torch.float64), torch.zeros((40, 40)), 7)
    assert TKer._check_level("pyr[0]", torch.zeros((16, 40)), torch.zeros((16, 40)), 7) == (16, 40)


def test_lk_track_args_describe_the_pyramids():
    import ctypes

    pyr = TK.build_pyramid(torch.zeros((48, 64)), 3)
    prev, nxt, Hs, Ws = TKer.lk_track_args(pyr, pyr)
    assert list(Hs) == [48, 24, 12] and list(Ws) == [64, 32, 16]
    assert [p for p in prev] == [im.data_ptr() for im in pyr] == [p for p in nxt]
    assert isinstance(prev, ctypes.Array) and len(prev) == 3


# ---------------------------------------------------------------------------
# FAST-9: the compass pretest
# ---------------------------------------------------------------------------


def _rendered(H=480, W=752):
    sim = Simulator(SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=90, seed=9),
                    trajectory=circle_trajectory(duration=14.0))
    img = sim.render_image(0.5)
    assert img.shape == (H, W)
    return TK.hist_equalize(_t(img))


@pytest.mark.parametrize("name", ["rendered", "random", "unaligned_65x257", "blobs"])
def test_fast_pretest_is_necessary_for_a_score(name):
    if name == "rendered":
        img = _rendered()
    elif name == "random":
        img = _t(np.random.default_rng(1).uniform(0, 255, (120, 188)))
    elif name == "unaligned_65x257":
        img = _t(np.random.default_rng(2).uniform(0, 255, (65, 257)))
    else:
        img = _t(_scene(7, 120, 160, 1, (0, 0))[0])
    score = TKer.fast_score_ref(img, 20.0)
    pre = TKer.fast_pretest(img, 20.0)
    corners = score > 0
    assert corners.sum() > 0
    assert (pre | ~corners).all()  # every corner passes the pretest
    if name == "rendered":  # and on a real frame it spares most pixels the ring
        assert pre.float().mean() < 0.5


def test_fast_pretest_counts_two_of_four():
    img = np.full((16, 16), 100.0, np.float32)
    img[8, 11] = 200.0  # one brighter compass pixel of (8, 8)
    assert not TKer.fast_pretest(_t(img), 20.0)[8, 8]
    img[11, 8] = 200.0  # two
    assert TKer.fast_pretest(_t(img), 20.0)[8, 8]
    img[11, 8] = 0.0  # one brighter, one darker
    assert not TKer.fast_pretest(_t(img), 20.0)[8, 8]
    img[8, 5] = 0.0  # two darker
    assert TKer.fast_pretest(_t(img), 20.0)[8, 8]
    assert not TKer.fast_pretest(_t(img), 120.0)[8, 8]


# ---------------------------------------------------------------------------
# the CUDA sources
# ---------------------------------------------------------------------------


def test_fast9_source_ring_tables_and_pretest_positions():
    src = _src("fast9.cu")
    table = lambda n: [int(v) for v in re.search(n + r"\[16\] = \{([^}]*)\}", src).group(1).split(",")]
    ring = list(zip(table("c_ring_dy"), table("c_ring_dx")))
    assert ring == TKer._CIRCLE == JK._CIRCLE
    # the pretest reads E, S, W, N = ring positions 0, 4, 8, 12
    assert ring[::4] == [(0, 3), (3, 0), (0, -3), (-3, 0)]
    assert "kPX = 4" in src and "float4" in src


def test_lk_source_constants_match_the_plain_versions():
    src = _src("lk_level.cu")
    const = lambda n: int(re.search(r"constexpr int " + n + r" = (\d+);", src).group(1))
    assert const("kMargin") == TKer.LK_SLAB_MARGIN
    assert const("kMaxLevels") == TKer.LK_MAX_LEVELS
    assert const("kSlabMax") == TKer.slab_extent(TKer.LK_MAX_HALF, 10**6)
    assert const("kSlots") >= (2 * TKer.LK_MAX_HALF + 1) ** 2
    assert "P + 1 + 2 * kMargin" in src


@pytest.mark.parametrize("entry,source", [
    ("uvio_lk_track", "lk_level.cu"), ("uvio_lk_level", "lk_level.cu"),
    ("uvio_fast9", "fast9.cu"), ("uvio_empty_launch", "yardstick.cu"),
    ("uvio_uwb_update", "uwb_update.cu"), ("uvio_uwb_shared_memory", "uwb_update.cu"),
    ("uvio_slam_init", "slam_init.cu"), ("uvio_msckf_update", "msckf_update.cu"),
    ("uvio_msckf_work_bytes", "msckf_update.cu"),
])
def test_entry_points_exported_and_bound(entry, source):
    src = _src(source)
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m, f"{entry} is not exported from {source}"
    n_params = len([p for p in m.group(1).split(",") if p.strip()])

    class FakeLib:  # stands in for the CDLL: bind() sets argtypes on what it finds
        pass

    lib = FakeLib()
    fn = type("Fn", (), {})()
    setattr(lib, entry, fn)
    _build.bind(lib)
    assert len(fn.argtypes) == n_params
    assert os.path.join(CSRC, source) in _build.sources()
    if entry in ("uvio_uwb_update", "uvio_slam_init", "uvio_msckf_update"):  # the filter kernels' one signature
        assert " ".join(m.group(1).split()) == ("const int64_t* ptrs, const int* ints, const double* reals, "
                                                "cudaStream_t stream")
        assert fn.argtypes == [ctypes.c_void_p] * 4


def test_header_edits_change_the_library_digest(tmp_path, monkeypatch):
    """The library is stamped with a hash of the sources and the headers
    they include: an edit to the filter kernels' shared header, or a new
    header, makes a built library stale."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    assert sorted(os.listdir(csrc)) == sorted([*map(os.path.basename, _build.sources()), "mean_table.cuh",
                                               "small_linalg.cuh"])
    before = _build._digest()
    with open(csrc / "mean_table.cuh", "a") as f:
        f.write("// an edit\n")
    edited = _build._digest()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert len({before, edited, _build._digest()}) == 3


def test_lk_bound_counts_each_touched_pixel_once():
    """`chip_smoke.py`'s bound for the LK kernels moves the distinct
    pixels under the features' blocks: never more than the pyramids hold,
    and for one still feature exactly a template and a window block a
    level."""
    import importlib.util

    path = os.path.join(os.path.dirname(CSRC), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    img1, _, uv = _scene(3, 200, 260, 400, (0, 0))
    pyr = TK.build_pyramid(_t(img1), smoke.LEVELS)
    inp = {"pyr0": pyr, "pyr1": pyr, "uv0": _t(uv), "valid": torch.ones(400, dtype=torch.bool)}
    many = smoke.lk_bounds(TKer, inp)
    sizes = [8 * im.numel() for im in reversed(pyr)]  # both images of a level, coarse to fine
    assert all(b <= n for b, n in zip(many["image_bytes_coarse_to_fine"], sizes))
    # 400 features' blocks cover the coarsest level several times over
    assert many["image_bytes_coarse_to_fine"][0] > 0.9 * sizes[0]
    assert many["image_bytes"] < 400 * smoke.LEVELS * 2 * 16 * 16 * 4 / 2
    one = smoke.lk_bounds(TKer, {**inp, "uv0": _t([[130.3, 99.6]]), "valid": torch.ones(1, dtype=torch.bool)})
    assert one["image_bytes"] == smoke.LEVELS * 2 * 16 * 16 * 4
    assert one["lk_track"][0] > 0 and one["lk_track"][1] in ("bytes", "operations")


# ---------------------------------------------------------------------------
# the card by default
# ---------------------------------------------------------------------------


def _layout():
    from uvio_tpu_torch.types import StateLayout

    return StateLayout(max_clones=4, max_slam=0)


def _entry_point_calls():
    from uvio_tpu_torch.fixtures import load_full_step_fixture
    from uvio_tpu_torch.frontend.fused_vio import make_fused_vio_step
    from uvio_tpu_torch.pipeline import bundle_from_numpy
    from uvio_tpu_torch.types import init_state
    from uvio_tpu_torch.types.state import carry_from_numpy, state_from_numpy, state_to_numpy

    carry = ([np.zeros((8, 8))], np.zeros((3, 2)), np.zeros(3, bool), np.zeros((3, 4, 2)),
             np.zeros((3, 4), bool))
    return {
        "init_state": lambda **kw: init_state(_layout(), **kw).cov,
        "state_from_numpy": lambda **kw: state_from_numpy(
            state_to_numpy(init_state(_layout(), device="cpu")), **kw).cov,
        "carry_from_numpy": lambda **kw: carry_from_numpy(carry, **kw)[1],
        "bundle_from_numpy": lambda **kw: bundle_from_numpy(
            load_full_step_fixture().bundles[0], **kw).imu_t,
        "make_fused_vio_step": lambda **kw: make_fused_vio_step(
            _layout(), np.ones(8), 0, num_features=4, **kw)[1](np.zeros((64, 64), np.float32))[1],
    }


@pytest.fixture
def full_float32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_default_device_is_the_card_or_an_error():
    if torch.cuda.is_available():
        assert uvio_tpu_torch.default_device() == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            uvio_tpu_torch.default_device()
    from uvio_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


@pytest.mark.parametrize("name", ["init_state", "state_from_numpy", "carry_from_numpy",
                                  "bundle_from_numpy", "make_fused_vio_step"])
def test_entry_points_default_to_the_card(name, full_float32):
    call = _entry_point_calls()[name]
    assert call(device="cpu").device.type == "cpu"  # asked for: works as before
    if torch.cuda.is_available():
        assert call().device == torch.device("cuda:0")
    else:  # no quiet CPU: the same error as default_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
