"""flush_compaction_pct: the share of the window spent inside the
program's ``flush`` and ``compaction`` spans (its telemetry histograms'
sums over the window, host clock)."""


def read(run):
    s = run.span_s.get("flush", 0.0) + run.span_s.get("compaction", 0.0)
    return 100.0 * s / run.window_s if s else None
