"""The check fails what it must fail.  The control (every read served
from a snapshot taken before the load's last sixteenth: stale reads) and a
run whose timed path is broken as the window opens come out not correct,
for each fault a cell can have, as its mix says (``faults.faults_of``).
One chip: no exchange between chips to leave out."""
import pytest

from conftest import CELLS, mix_of, run_cell
from faults import faults_of


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = run_cell(cell, control=True)
    assert out["correct"] is False
    assert out["compared"]["wrong_answers"]["value"] > 0
    assert out["failed"] > 0


@pytest.mark.parametrize("cell,fault",
                         [(c, f) for c in CELLS for f in faults_of(mix_of(c))],
                         ids=lambda x: getattr(x, "__name__", x))
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.core import LSMStore
    out = run_cell(cell, on_window=lambda: fault(LSMStore, monkeypatch))
    assert out["correct"] is False, (cell, fault.__name__)
    assert out["failed"] > 0


def op(kind, batch=None):
    return {"kind": kind, **({} if batch is None else {"batch": batch})}


@pytest.mark.parametrize("ops,want", [
    ([op("read", 65536)], "half_read_batch altered_read"),
    ([op("read", 1)], "altered_get"),
    ([op("read")], "altered_get"),
    ([op("scan"), op("insert", 1)], "unchanged_state half_scan altered_scan"),
    ([op("update", 65536)],
     "unchanged_state half_write_batch altered_write"),
    ([op("insert", 64), op("read", 1), op("read", 64)],
     "unchanged_state half_read_batch half_write_batch altered_get "
     "altered_read altered_write"),
], ids=["read_batch", "read_one", "read_default", "scan_insert", "update",
        "mixed"])
def test_faults_follow_the_mix(ops, want):
    assert [f.__name__ for f in faults_of({"ops": ops})] == want.split()


def test_an_op_kind_with_no_faults_is_refused():
    with pytest.raises(ValueError, match="delete"):
        faults_of({"ops": [op("delete", 4)]})
