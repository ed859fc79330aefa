"""kernel_launches_per_call: launches of the main path's C entries
(``kernels.LAUNCHES`` but the ``probe_*`` entries; not PyTorch's own
kernels) in the traced window per ``match_batch``."""


def read(record):
    t = record.traced
    return None if t is None or not t.calls else t.launches / t.calls
