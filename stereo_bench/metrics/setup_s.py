"""setup_s: from the process's start to the window's start: imports, the
CUDA context, the kernels' build or load, the inputs, the warm-up."""


def read(record):
    return record.setup_s
