"""The 90th percentile of every job's latency in the window, issue to answer on the
host, in ms (linear interpolation between order statistics)."""

import numpy as np


def read(w):
    return float(np.percentile(np.asarray(w.latencies) * 1e3, 90)) if w.latencies else None
