"""mixtral-8x22b — 8-expert top-2 MoE, sliding-window attention
[arXiv:2401.04088; hf]. Window 4096 per the assigned spec."""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    layer_pattern=(LayerSpec("swa", moe=True),),
    window=4096,
    n_experts=8, top_k=2, expert_ff=16384,
    mlp_type="swiglu", rope_theta=1000000.0,
)
