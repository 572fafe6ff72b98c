"""deepseek-coder-33b — llama-arch dense decoder [arXiv:2401.14196; hf]."""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19200, vocab_size=32256,
    layer_pattern=(LayerSpec("full"),),
    mlp_type="swiglu", rope_theta=100000.0,
)
