"""internvl2-26b — InternViT + InternLM2 VLM [arXiv:2404.16821; hf].

LLM BACKBONE only: the InternViT frontend is a stub — input_specs()
supplies 256 precomputed patch embeddings (B, 256, d_model) prepended to
the text embeddings. Loss/logits are evaluated on text positions.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553,
    layer_pattern=(LayerSpec("full"),),
    mlp_type="swiglu", rope_theta=1000000.0,
    frontend="vision", n_frontend_tokens=256,
)
