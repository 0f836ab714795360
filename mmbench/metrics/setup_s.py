"""setup_s: seconds from the process's start to the window's: imports,
the CUDA context, the kernels' build where the checkout has none, the
fleet and its records, the cold refresh and the warm ones."""


def read(run):
    return run.setup_s
