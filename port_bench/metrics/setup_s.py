"""setup_s: seconds from the process's start to the window's first frame
(imports, kernel build or load, traffic, the managers, the warm-up
frames and the CUDA graphs they capture), host clock."""


def read(run):
    return run.setup_s
