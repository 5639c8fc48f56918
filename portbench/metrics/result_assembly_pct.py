"""result_assembly_pct: the share of the window the point reads spent
assembling answers on the host (``multi_get.assemble``: the counters, the
per-hit value slicing, the placing of each run's answers)."""
from portbench.phase_share import share

PHASES = ("multi_get.assemble",)


def read(run):
    return share(run, "read", "multi_get", PHASES)
