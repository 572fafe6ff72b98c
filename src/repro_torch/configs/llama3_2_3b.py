"""llama3.2-3b — dense decoder [hf:meta-llama/Llama-3.2-3B; unverified]."""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=128256,
    layer_pattern=(LayerSpec("full"),),
    mlp_type="swiglu", rope_theta=500000.0,
)
