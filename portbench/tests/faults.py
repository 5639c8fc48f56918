"""The faults a cell's timed path can have, each planted on the store's
class as the window opens, and the faults of a cell derived from its mix:
a step that leaves the state unchanged (where the window writes), half of
a batch left out, and an answer altered where it is produced.  One chip:
no exchange between chips to leave out."""


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


def altered_get(S, mp):
    """One byte of a single-key read's value altered as ``get`` answers
    (``get`` does not go through ``multi_get``)."""
    get = S.get

    def altered(self, key, snapshot=None):
        v = get(self, key, snapshot)
        return None if v is None else flip(v)

    mp.setattr(S, "get", altered)


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


# in the order a cell's faults are listed
ALL = (unchanged_state, half_read_batch, half_write_batch, half_scan,
       altered_get, altered_read, altered_write, altered_scan)


def faults_of(mix: dict) -> tuple:
    """The faults the timed path of a cell with traffic ``mix`` can have,
    from its op kinds and batches: batched reads lose half a batch or
    alter a value, single reads alter ``get``'s answer, scans lose half
    their entries or alter one, writes leave the state unchanged, and
    batched writes also lose half a batch or store an altered value."""
    found = set()
    for op in mix["ops"]:
        batched = int(op.get("batch", 1)) > 1
        if op["kind"] == "read":
            found |= ({half_read_batch, altered_read} if batched
                      else {altered_get})
        elif op["kind"] == "scan":
            found |= {half_scan, altered_scan}
        elif op["kind"] in ("update", "insert"):
            found.add(unchanged_state)
            if batched:
                found |= {half_write_batch, altered_write}
        else:
            raise ValueError(f"no faults known for op kind {op['kind']!r}")
    return tuple(f for f in ALL if f in found)
