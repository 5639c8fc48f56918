"""setup_s: seconds from the run's start (the first line of ``run.py``,
before torch is imported) to the window's start: the CUDA context, the
kernels' build or load, the store's load from the seed and the warm-up."""


def read(run):
    return run.setup_s
