from .layout import StateLayout
from .state import FilterState, init_state

__all__ = ["FilterState", "StateLayout", "init_state"]
