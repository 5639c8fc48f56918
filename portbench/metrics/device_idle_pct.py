"""device_idle_pct.<cell>: the share of the traced window in which no
kernel, copy or fill ran on the card (100 less the union of the
profiler's device intervals over the window).  Nothing without device
events."""


def read(run):
    t = run.trace
    if t is None or not t.device_events:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
