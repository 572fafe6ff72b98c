"""admit_window_rows.tail: the mean rows an admission window held when it
closed, over the windows closed in the window (the controller's own
window counters)."""
from benchlib.readers import admission_windows


def read(ctx):
    d = admission_windows(ctx)
    if not d.get("flushed"):
        return None
    return d["flushed_rows"] / d["flushed"]
