"""flush_fill.tail: live rows a launch over the rows of the buckets the
service launched, in % (the service's per-bucket counters)."""
from benchlib.readers import service_launches


def read(ctx):
    d = service_launches(ctx)
    if not d.get("bucket_rows"):
        return None
    return 100.0 * d["queries"] / d["bucket_rows"]
