"""Seconds from the process's start to the window's start: imports, weights,
the program's objects, the clips and the warm-up (with a first run's kernel
build)."""


def read(run):
    return run.setup_s
