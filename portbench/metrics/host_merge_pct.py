"""host_merge_pct: the share of the window the range reads spent merging
on the host (``scan.merge``: the refills' clamp, sort and emission cap;
``scan.emit``: building the answer)."""
from portbench.phase_share import share

PHASES = ("scan.merge", "scan.emit")


def read(run):
    return share(run, "scan", "scan", PHASES)
