"""put_entries_per_s: entries written by updates and inserts over the
whole window, with the flushes and compactions they set off inside it."""


def read(run):
    n = run.units.get("update", 0) + run.units.get("insert", 0)
    return n / run.window_s if n else None
