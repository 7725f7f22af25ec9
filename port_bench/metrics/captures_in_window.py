"""captures_in_window: CUDA graphs the program captured inside the
window, the growth of its graphed callables' summed `stats()["graphs"]`
between the window's start and end: plans first met in the window."""


def read(run):
    return run.captures
