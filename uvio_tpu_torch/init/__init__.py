from .cpi import preintegrate, preintegrate_v1, preintegrate_v2
from .static_init import StaticInitOptions, StaticInitResult, gravity_aligned_quat, try_static_init

__all__ = [
    "StaticInitOptions",
    "StaticInitResult",
    "gravity_aligned_quat",
    "try_static_init",
    "preintegrate",
    "preintegrate_v1",
    "preintegrate_v2",
]
