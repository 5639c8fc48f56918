"""blocks_per_scan: data blocks range reads touched per range read over
the window (``IOStats.blocks_read / range_reads``)."""


def read(run):
    n = run.stats.get("range_reads", 0)
    return run.stats["blocks_read"] / n if n else None
