"""get_batch_p95_ms: the 95th percentile of every point-read request of
the window, each from its call to its return (host clock; NumPy's linear
percentile)."""
import numpy as np


def read(run):
    lat = run.latency_ms.get("read")
    return float(np.percentile(lat, 95)) if lat is not None and lat.size \
        else None
