"""The share of the window a request's phases took: what the readers of
the ``*_pct`` phase metrics share.

The program cuts each store call into phases (``<parent>.<phase>``, the
telemetry's histograms over the window, host clock, in ``run.span_s``).
A share is 100 times the summed seconds of the named phases over the
window.  It is read whenever requests of the kind ran in the window (0.0
where none of the named phases did) and the program cut their calls into
phases; a program that records no phase of ``parent`` gives nothing."""


def share(run, kind, parent, names):
    if not run.requests.get(kind):
        return None
    prefix = parent + "."
    if not any(k.startswith(prefix) for k in run.span_s):
        return None
    return 100.0 * sum(run.span_s.get(n, 0.0) for n in names) / run.window_s
