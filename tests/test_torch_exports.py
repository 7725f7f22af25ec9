"""Every name a `uvio_tpu` subpackage exports, its port exports too."""

import importlib

import pytest

SUBPACKAGES = ["cam", "eval", "filter", "frontend", "init", "math", "parallel", "sim", "types", "update", "utils"]


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_port_exports_cover_the_reference(name):
    ref = importlib.import_module(f"uvio_tpu.{name}")
    port = importlib.import_module(f"uvio_tpu_torch.{name}")
    missing = sorted(set(ref.__all__) - set(port.__all__))
    assert not missing, missing
    for attr in port.__all__:
        assert hasattr(port, attr), attr
