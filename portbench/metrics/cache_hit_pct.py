"""cache_hit_pct: the share of the block reads the block cache and the
pinned L0 answered over the window, 100 x ``cache_hit_blocks`` /
(``cache_hit_blocks`` + ``cache_miss_blocks``), the store's IOStats.
Nothing where no block read went through a cache."""


def read(run):
    hits = run.stats.get("cache_hit_blocks", 0)
    n = hits + run.stats.get("cache_miss_blocks", 0)
    return 100.0 * hits / n if n else None
