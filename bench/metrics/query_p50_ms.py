"""query_p50_ms: the median, over every answered query due in the window,
of the time from its due time to its answer."""
import numpy as np


def read(rec):
    if not rec.latencies_s:
        return None
    return float(np.percentile(np.asarray(rec.latencies_s), 50)) * 1e3
