"""Seconds from the start of the process to the start of the window:
torch's import, the data, the index, the engine, the kernels' builds and
the warm-up requests."""


def read(run):
    return run["setup_s"]
