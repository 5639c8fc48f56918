"""memtable_probe_pct: the share of the window the point reads spent
probing the memtable for every key (the program's
``multi_get.memtable_probe`` phase, host clock)."""
from portbench.phase_share import share

PHASES = ("multi_get.memtable_probe",)


def read(run):
    return share(run, "read", "multi_get", PHASES)
