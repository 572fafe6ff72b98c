"""decision: the slab decision function, the serving hot path."""
