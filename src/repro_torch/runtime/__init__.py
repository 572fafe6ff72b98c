"""repro_torch.runtime — the supervised step loop with checkpoint and
restart, and the heartbeat table (``fault_tolerance``)."""
