"""Seconds from process start to the start of the first timed batch or
step: imports, the card, the kernel library's load (its build on a
checkout's first run), weights, checkpoints and the warm-up."""


def read(run):
    return run.setup_s
