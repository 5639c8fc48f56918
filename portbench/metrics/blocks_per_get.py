"""blocks_per_get: data blocks point reads touched per key read over the
window (the store's ``IOStats.blocks_read / point_reads``)."""


def read(run):
    n = run.stats.get("point_reads", 0)
    return run.stats["blocks_read"] / n if n else None
