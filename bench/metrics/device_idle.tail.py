"""The share of the traced window in which nothing ran on the device, in
% (one minus the union of the device's intervals over the window)."""
from benchlib.readers import device_idle


def read(ctx):
    return device_idle(ctx)
