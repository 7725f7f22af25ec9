"""Port parity, the config loader (`utils/config.py`): the port's
`load_config` against `uvio_tpu.utils.load_config` on the three vendored
config directories (`data/streams/{mono,stereo,uwb}/config`), field by
field through the nested configurations (cameras, noises, the static and
dynamic init options, anchors), `extras` included. Floats parsed from
the same text are equal; quaternions computed from the same rotation
matrices agree to 1e-12. The port's one extra field, `device`, is what
the caller passed."""

import dataclasses
import os

import numpy as np
import pytest

from uvio_tpu.utils import load_config as j_load

from uvio_tpu_torch.utils import load_config as t_load

STREAMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "streams")


def _assert_same(a, b, where):
    """`b` (the port's) equals `a` (uvio_tpu's), recursively."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b) and type(a).__name__ == type(b).__name__, where
        names = [f.name for f in dataclasses.fields(a)]
        extra = {f.name for f in dataclasses.fields(b)} - set(names)
        assert extra <= {"device"}, (where, extra)
        for n in names:
            _assert_same(getattr(a, n), getattr(b, n), f"{where}.{n}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, np.ndarray) or hasattr(a, "__array__"):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=1e-12, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("stream", ["mono", "stereo", "uwb"])
def test_load_config_matches(stream):
    path = os.path.join(STREAMS, stream, "config")
    jcfg, jextras = j_load(path)
    tcfg, textras = t_load(path, device="cpu")
    assert type(tcfg).__name__ == type(jcfg).__name__ == ("UVioConfig" if stream == "uwb" else "VioConfig")
    assert tcfg.device == "cpu"
    _assert_same(jcfg, tcfg, stream)
    _assert_same(jextras, textras, f"{stream} extras")
    assert tcfg.use_dynamic_init and tcfg.dyn_init_options.gn_iters == 50
    if stream == "uwb":
        assert len(tcfg.anchors) == 4
    # a file path works as the directory does, and None is the card
    assert t_load(os.path.join(path, "estimator_config.yaml"))[0].device is None
