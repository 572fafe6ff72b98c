"""flush_ms.tail: the mean seconds of one of the service's launches, as
the service times them (through the scores' copy to the host, so each
ends at the device), in ms."""
from benchlib.readers import service_launches


def read(ctx):
    d = service_launches(ctx)
    if not d.get("batches"):
        return None
    return 1e3 * d["total_s"] / d["batches"]
