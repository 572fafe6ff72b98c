"""Hand-written CUDA kernels for the solver's and the server's hot spots.

fupdate  — fused kernel-row evaluation + rank-S f-cache update (SMO loop)
decision — batched slab decision function (serving hot path)

Each family: ops.py (the wrapper: plain version for CPU tensors, the
kernel for CUDA tensors) and ref.py (the plain versions). The CUDA
sources are in ``repro_torch/csrc`` and are built by ``_build`` at first
launch. Shared policy lives beside them: ``precision`` (the
"f32"/"bf16"/"f16" tile-stream knob) and ``tiling`` (padding).
"""
