"""peak_mem_gib: ``torch.cuda.max_memory_allocated()``, reset once the
CUDA context is up and read when the window closes, in GiB."""


def read(record):
    return record.peak_bytes / 2 ** 30
