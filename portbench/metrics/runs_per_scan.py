"""runs_per_scan: sorted runs range reads examined per range read over
the window (``IOStats.runs_touched_range / range_reads``)."""


def read(run):
    n = run.stats.get("range_reads", 0)
    return run.stats["runs_touched_range"] / n if n else None
