from .ba import BAOptions, ba_solve
from .map_backend import MapBackend, MapBackendOptions

__all__ = ["BAOptions", "ba_solve", "MapBackend", "MapBackendOptions"]
