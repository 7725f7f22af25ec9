"""uvio_tpu_torch — the PyTorch/CUDA port of `uvio_tpu`.

The package mirrors `uvio_tpu`'s subpackage and module names, so each
counterpart is easy to find. It imports `torch`, numpy and scipy, and
never `jax` or `uvio_tpu`: importing `uvio_tpu` changes global JAX
configuration, and the port must run on a machine without JAX.

Conventions:
  * plain functions on tensors; carried state is a dataclass of tensors;
  * every constructor takes a `device`; None means `default_device()`,
    which is `cuda:0` or a `RuntimeError` — never a quiet CPU (the CPU
    parity tests pass `device="cpu"`); every random draw takes an
    explicit `torch.Generator` (or the noise itself, for parity tests);
  * `vmap` is a written-out batch dimension (except
    `pipeline.make_batched_step`, `torch.func.vmap` of the single-sequence
    step), `lax.fori_loop` a Python loop with a fixed count;
  * inside the per-frame step nothing synchronises with the host (no
    `.item()`, no `bool(tensor)`), so on the card each step is captured
    once per static key as a CUDA graph and replayed (`graphs.py`, the
    counterpart of `jax.jit`).

The two Pallas kernels of `uvio_tpu/frontend/pallas_kernels.py` are
hand-written CUDA kernels for Hopper (`csrc/`), built at first use by
`_build.py` and wrapped in `frontend/kernels.py`.
"""

from .device import default_device

__version__ = "0.1.0"
__all__ = ["default_device"]
