"""setup_s (end to end, host clock): the process's start to the window's:
imports, the kernels' build (cached in the checkout), the weights, the
traffic's pool and its prep, the program's warm-up and graph capture."""


def read(run):
    return run["setup_s"]
