"""Optimizers and LR schedules over trees of tensors (the JAX package's
``repro.optim``): ``adamw`` (f32 moments), ``adafactor`` (factored second
moments over the stacked layout) and ``schedules``. Gradient compression
belongs to the sharded slice."""
