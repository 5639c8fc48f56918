"""get_keys_per_s: keys answered by point reads over the whole window."""


def read(run):
    n = run.units.get("read", 0)
    return n / run.window_s if n else None
