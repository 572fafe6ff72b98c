"""rwkv6-7b "Finch" — attention-free, data-dependent decay
[arXiv:2404.05892; hf]. 64 heads x 64 dims; squared-ReLU channel mix."""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=0, head_dim=64,
    d_ff=14336, vocab_size=65536,
    layer_pattern=(LayerSpec("rwkv"),),
    rwkv_head_dim=64,
    mlp_type="relu2",
)
