"""The decision kernel's share of its roofline, in %: the least time the
card could take for the window's decision work (``yardstick``: FLOPs of
every live query-support pair at the tile precision's peak, or each
input byte read once and the output written once at the HBM bandwidth,
whichever is longer) over the device time of the decision's kernels in
the trace."""
from benchlib.readers import decision_roofline


def read(ctx):
    return decision_roofline(ctx)
