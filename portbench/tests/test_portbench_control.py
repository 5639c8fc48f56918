"""The check fails what it must fail.  The control (every read served
from a snapshot taken before the load's last sixteenth: stale reads) and a run whose
timed path is broken as the window opens come out not correct, for each
fault a cell can have.  One chip: no exchange between chips to leave
out."""
import pytest

from conftest import CELLS, run_cell


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = run_cell(cell, control=True)
    assert out["correct"] is False
    assert out["compared"]["wrong_answers"]["value"] > 0
    assert out["failed"] > 0


def flip(v: bytes) -> bytes:
    return bytes([v[0] ^ 1]) + v[1:]


def unchanged_state(S, mp):
    """Writes acknowledged and dropped: the store's state stays as it
    was."""
    mp.setattr(S, "put_batch", lambda self, keys, values: None)
    mp.setattr(S, "put", lambda self, key, value: None)


def half_read_batch(S, mp):
    """Every read batch answers its first half only; the rest reads
    nothing."""
    get = S.multi_get

    def multi_get(self, keys, snapshot=None):
        h = len(keys) // 2
        return get(self, keys[:h], snapshot) + [None] * (len(keys) - h)

    mp.setattr(S, "multi_get", multi_get)


def half_write_batch(S, mp):
    """Every write batch writes its first half only."""
    put = S.put_batch

    def put_batch(self, keys, values):
        h = max(1, len(keys) // 2)
        return put(self, keys[:h], values[:h])

    mp.setattr(S, "put_batch", put_batch)


def half_scan(S, mp):
    """Every scan returns half of its entries."""
    scan = S.scan

    def halved(self, start, count, snapshot=None):
        got = scan(self, start, count, snapshot)
        return got[:len(got) // 2]

    mp.setattr(S, "scan", halved)


def altered_read(S, mp):
    """One byte of one value altered as a read batch answers."""
    get = S.multi_get

    def multi_get(self, keys, snapshot=None):
        out = get(self, keys, snapshot)
        for i, v in enumerate(out):
            if v is not None:
                out[i] = flip(v)
                break
        return out

    mp.setattr(S, "multi_get", multi_get)


def altered_scan(S, mp):
    """One byte of a scan's last value altered as the scan answers."""
    scan = S.scan

    def altered(self, start, count, snapshot=None):
        out = scan(self, start, count, snapshot)
        if out:
            out[-1] = (out[-1][0], flip(out[-1][1]))
        return out

    mp.setattr(S, "scan", altered)


def altered_write(S, mp):
    """One byte of one value altered as a write batch stores it (the
    batch's last, which no later write of the batch overwrites)."""
    put = S.put_batch

    def put_batch(self, keys, values):
        return put(self, keys, list(values[:-1]) + [flip(values[-1])])

    mp.setattr(S, "put_batch", put_batch)


# the faults each cell's timed path can have: a step that leaves the state
# unchanged (where the window writes), half of a batch left out, and an
# answer altered where it is produced
FAULTS = {"dbbench.readrandom": (half_read_batch, altered_read),
          "ycsb.e": (unchanged_state, half_scan, altered_scan),
          "dbbench.overwrite": (unchanged_state, half_write_batch,
                                altered_write)}


@pytest.mark.parametrize("cell,fault",
                         [(c, f) for c in CELLS for f in FAULTS[c]],
                         ids=lambda x: getattr(x, "__name__", x))
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.core import LSMStore
    out = run_cell(cell, on_window=lambda: fault(LSMStore, monkeypatch))
    assert out["correct"] is False, (cell, fault.__name__)
    assert out["failed"] > 0
