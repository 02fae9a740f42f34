"""setup_s: process start to the first measured cycle (imports, the
kernels' build or reuse, cluster generation, Scheduler start, placing the
running pods and the warm-up cycles)."""


def read(run):
    return run.setup_s
