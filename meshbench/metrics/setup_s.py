"""Seconds from the harness's start to the window's: imports, the kernel
library (built by nvcc on a checkout's first run, loaded from its cache
after) and the warm-up job."""


def read(run):
    return run.setup_s
