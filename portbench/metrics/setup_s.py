"""Set-up: from the start of the run's process (before torch is imported)
to the start of the window: imports, the CUDA context, building or
loading the kernel library and the native runtime, the frame pool, the
encoder session and the warm-up calls."""


def read(run):
    return run.setup_s
