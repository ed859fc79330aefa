"""plan_queries_per_call: calls of the program's asking C entries
(``kernels.PLAN_QUERIES``) in the traced window per ``match_batch``."""


def read(record):
    t = record.traced
    return None if t is None or not t.calls else t.plan_queries / t.calls
