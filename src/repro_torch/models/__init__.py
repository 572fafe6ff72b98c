"""The LM decoder stack: shared layers, GQA attention with KV caches, the
top-k MoE, Mamba and RWKV6 mixers and the decoder over an arch's layer
pattern — the JAX package's ``repro.models``, module for module, in
plain PyTorch (that package computes them outside any Pallas kernel)."""
