"""Set-up: from the benchmark's start to the window's (import, CUDA
context, the kernel library, inputs, warm-up, a stream's bootstrap)."""


def read(run):
    return run.setup_s
