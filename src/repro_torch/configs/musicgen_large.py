"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Transformer BACKBONE only: the EnCodec frontend is a stub — input_specs()
supplies precomputed frame embeddings (B, S, d_model) in place of the token
embedding; the head predicts the 2048-entry codebook. MHA (kv == q heads).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048,
    layer_pattern=(LayerSpec("full"),),
    mlp_type="gelu", rope_theta=10000.0,
    frontend="audio",
)
