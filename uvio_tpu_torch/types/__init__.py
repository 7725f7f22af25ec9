from .layout import StateLayout
from .state import FilterState, init_state, num_clones, oldest_clone_slot, where_state

__all__ = ["FilterState", "StateLayout", "init_state", "num_clones", "oldest_clone_slot", "where_state"]
