"""wal_append_pct: the share of the window the batched writes spent
framing and checksumming their write-ahead log records
(``put_batch.wal_append``)."""
from portbench.phase_share import share

PHASES = ("put_batch.wal_append",)


def read(run):
    return share(run, "update", "put_batch", PHASES)
