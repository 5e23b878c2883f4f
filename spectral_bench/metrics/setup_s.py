"""setup_s: seconds from the process's start until the first timed unit
can be issued (imports, CUDA context, the kernel library from the
checkout's cache or its build, the scene, one warm-up unit of the cell's
shape)."""


def read(run):
    return run.setup_s
