"""The whole window's share of the card's peak, in %: the useful FLOPs of
every row scored against every support row over the traced window's
seconds at the peak of the configuration's tile precision."""
from benchlib.readers import mfu


def read(ctx):
    return mfu(ctx)
