"""score_p95_ms: the 95th percentile of every request's latency, from
its due time to its scores (host clock); a request with no answer counts
with the whole run's wait."""
from benchlib.yardstick import percentile


def read(ctx):
    lat = ctx["window"].get("latencies_s")
    if not lat:
        return None
    return 1e3 * percentile(lat, 95)
