"""scorer_host_ms.rate: the mean host milliseconds of one
``BatchScorer.score`` call on device rows (the enqueue: padding, casts,
norms, the launch), from the benchmark's span around each call."""


def read(ctx):
    spans = ctx["window"].get("scorer_host_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
