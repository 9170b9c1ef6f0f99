"""setup_s: seconds from the process's start to the window's: loading,
building the kernels, making the weights and pools, the checked steps and
the warm-up."""


def read(run):
    return run.setup_s
