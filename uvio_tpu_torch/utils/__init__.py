from .config import load_config
from .logger import (
    get_verbosity,
    print_all,
    print_debug,
    print_error,
    print_info,
    print_warning,
    set_verbosity,
)

__all__ = [
    "load_config",
    "set_verbosity",
    "get_verbosity",
    "print_all",
    "print_debug",
    "print_info",
    "print_warning",
    "print_error",
]
