"""arctic-480b — 128-expert top-2 MoE + dense residual MLP
[hf:Snowflake/snowflake-arctic-base; hf].

Every layer: GQA attention + (dense residual MLP || 128e top-2 MoE), both
with ff=4864. Adafactor optimizer (AdamW's two f32 moments per parameter
are too large at 480B).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000,
    layer_pattern=(LayerSpec("full", moe=True),),
    n_experts=128, top_k=2, expert_ff=4864, dense_residual_ff=4864,
    mlp_type="swiglu", rope_theta=500000.0,
    optimizer="adafactor",
)
