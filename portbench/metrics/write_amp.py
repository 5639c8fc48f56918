"""write_amp: bytes the store wrote per byte it flushed over the window,
``(IOStats.bytes_flushed + bytes_compacted) / bytes_flushed``."""


def read(run):
    f = run.stats.get("bytes_flushed", 0)
    return (f + run.stats["bytes_compacted"]) / f if f else None
