"""Where the port's entry points put their tensors.

The port runs on the card unless the caller asks for the CPU: every
entry point that takes `device=None` resolves it through
`resolve_device`, which gives `cuda:0` or raises. There is no quiet
fall-back to the CPU; the CPU parity tests pass `device="cpu"`.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """`cuda:0`; a `RuntimeError` when this process sees no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "uvio_tpu_torch: no CUDA device (torch.cuda.is_available() is False); "
            'its entry points run on cuda:0 by default, pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda:0")


def resolve_device(device=None) -> torch.device:
    """`device` as a `torch.device`, `default_device()` for None."""
    return default_device() if device is None else torch.device(device)
