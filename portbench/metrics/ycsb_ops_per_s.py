"""ycsb_ops_per_s: every request of the window (reads, scans, updates and
inserts alike) over the whole window."""


def read(run):
    n = sum(run.requests.values())
    return n / run.window_s if n else None
