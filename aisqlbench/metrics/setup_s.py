"""Seconds from the start of the process until the window opens: imports,
the CUDA context, kernels loaded or built, the engine, the seeded weights,
the catalog and the warm-up."""


def read(run):
    return run.setup_s
