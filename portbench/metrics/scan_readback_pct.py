"""scan_readback_pct: the share of the window the range reads spent
seeking and reading windows and values back from the card (the phases
``scan.seek``, ``scan.windows``, ``scan.fetch``)."""
from portbench.phase_share import share

PHASES = ("scan.seek", "scan.windows", "scan.fetch")


def read(run):
    return share(run, "scan", "scan", PHASES)
