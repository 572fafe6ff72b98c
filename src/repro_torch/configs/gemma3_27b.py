"""gemma3-27b — 5:1 local:global attention, 128k ctx [hf:google/gemma-3-27b-pt; unverified].

62 layers = 10 full (5 SWA + 1 global) periods + 2 SWA tail layers.
GeGLU MLPs, 1024-token sliding window on local layers, head_dim 128
(decoupled from d_model / n_heads, as in the released config).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144,
    layer_pattern=(LayerSpec("swa"), LayerSpec("swa"), LayerSpec("swa"),
                   LayerSpec("swa"), LayerSpec("swa"), LayerSpec("full")),
    window=1024,
    mlp_type="geglu", rope_theta=1000000.0,
)
