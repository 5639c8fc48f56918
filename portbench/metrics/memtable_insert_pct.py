"""memtable_insert_pct: the share of the window the batched writes
spent inserting into the memtable (``put_batch.memtable_insert``)."""
from portbench.phase_share import share

PHASES = ("put_batch.memtable_insert",)


def read(run):
    return share(run, "update", "put_batch", PHASES)
