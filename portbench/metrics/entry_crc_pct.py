"""entry_crc_pct: the share of the window the flushes and compactions
the writes set off spent on the new runs' entry and block checksums
(``flush.entry_crc``, ``compaction.entry_crc``)."""
from portbench.phase_share import share

PHASES = ("flush.entry_crc", "compaction.entry_crc")


def read(run):
    return share(run, "update", "put_batch", PHASES)
