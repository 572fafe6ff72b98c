"""Hand-written CUDA kernels for the solver's and the server's hot spots.

gram     — the full kernel matrix k(X, Y) (the autotuner's cells)
fupdate  — fused kernel-row evaluation + rank-S f-cache update (SMO loop)
decision — batched slab decision function (serving hot path)

Each family: ops.py (the wrapper: plain version for CPU tensors, the
kernel for CUDA tensors) and ref.py (the plain versions). The CUDA
sources are in ``repro_torch/csrc`` and are built by ``_build`` at first
launch. Shared policy lives beside them: ``precision`` (the
"f32"/"bf16"/"f16" tile-stream knob), ``tiling`` (padding, each kernel's
menu of launch shapes and the tuned table ``tuned_configs.json``;
``REPRO_NO_AUTOTUNE=1`` opts out) and ``autotune`` (the sweep on the card
that writes the table: ``python -m repro_torch.kernels.autotune``, not
re-exported here).

``gram`` is re-exported, as in the JAX package, so the attribute
``repro_torch.kernels.gram`` is the function; its modules are reached by
``from repro_torch.kernels.gram import ops, ref``.
"""
from repro_torch.kernels.gram.ops import gram

__all__ = ["gram"]
