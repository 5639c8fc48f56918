"""cache_pct: the share of the window the point reads spent in the block
cache's accounting (``multi_get.cache``: each run's candidate block ids
and ``BlockCache.read_blocks``, host clock).  Nothing from a program that
cuts no ``cache`` phase, as one without it has none."""
from portbench.phase_share import share

PHASES = ("multi_get.cache",)


def read(run):
    if PHASES[0] not in run.span_s:
        return None
    return share(run, "read", "multi_get", PHASES)
