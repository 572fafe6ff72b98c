"""minitron-8b — pruned nemotron dense decoder [arXiv:2407.14679; hf].

Nemotron lineage uses squared-ReLU non-gated MLPs.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=256000,
    layer_pattern=(LayerSpec("full"),),
    mlp_type="relu2", rope_theta=500000.0,
)
