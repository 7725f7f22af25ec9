from .static_init import StaticInitOptions, StaticInitResult, gravity_aligned_quat, try_static_init

__all__ = ["StaticInitOptions", "StaticInitResult", "gravity_aligned_quat", "try_static_init"]
