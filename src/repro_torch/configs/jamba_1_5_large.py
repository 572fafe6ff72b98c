"""jamba-1.5-large-398b — Mamba+attention 1:7 interleave with 16e top-2 MoE
every other layer [arXiv:2403.19887; hf].

Period of 8: one attention layer then seven Mamba layers; MoE MLP on odd
period positions (every 2nd layer). 72 layers = 9 periods. Adafactor (398B).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

_PERIOD = tuple(
    LayerSpec("full" if i == 0 else "mamba", moe=(i % 2 == 1))
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    layer_pattern=_PERIOD,
    n_experts=16, top_k=2, expert_ff=24576,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    mlp_type="swiglu", rope_theta=1000000.0,
    optimizer="adafactor",
)
