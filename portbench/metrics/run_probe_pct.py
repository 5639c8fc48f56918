"""run_probe_pct: the share of the window the point reads spent on the
runs' device probes up to their read-backs (``multi_get.run_probe``: K1,
``searchsorted``, the wait for the hits, the copy to the host)."""
from portbench.phase_share import share

PHASES = ("multi_get.run_probe",)


def read(run):
    return share(run, "read", "multi_get", PHASES)
