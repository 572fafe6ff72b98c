"""gen_lag_p95_ms.tail: the 95th percentile of how late the traffic
generator sent a request after its due time (host clock): its own stalls,
and the submits that flushed a full window inline."""
import math

from benchlib.yardstick import percentile


def read(ctx):
    lag = [x for x in ctx["window"].get("gen_lag_s") or ()
           if not math.isnan(x)]
    if not lag:
        return None
    return 1e3 * percentile(lag, 95)
