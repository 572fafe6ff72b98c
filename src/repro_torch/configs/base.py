"""Unified architecture configuration for the LM model pool.

Every architecture is described by a repeating ``layer_pattern`` of
``LayerSpec``s (mixer kind + MoE flag). The JAX package stacks the
parameters of whole pattern periods and scans over them; the port keeps
one module per layer in order (``models.transformer``), and the period
fixes which ``LayerSpec`` each layer takes. A partial tail period follows
the whole ones.

Mixer kinds: "full" (causal GQA), "swa" (sliding-window GQA), "mamba"
(selective SSM), "rwkv" (RWKV6 Finch time-mix).

The fields, ``param_count``, ``active_param_count``, ``padded_vocab`` and
``reduced()`` are the JAX package's (``repro.configs.base``), copied;
``dtype`` is a ``torch.dtype`` (``param_dtype`` stays the string).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "full"          # full | swa | mamba | rwkv
    moe: bool = False


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    window: int = 0              # sliding-window size for "swa" mixers
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 2
    expert_ff: int = 0
    dense_residual_ff: int = 0   # arctic-style parallel dense MLP
    capacity_factor: float = 1.25
    # --- MLP ---
    mlp_type: str = "swiglu"     # swiglu | geglu | relu2 | gelu
    # --- SSM (mamba) ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0             # 0 => d_model // 16
    # --- RWKV ---
    rwkv_head_dim: int = 64
    # --- modality frontend (stub) ---
    frontend: str = "none"       # none | audio | vision
    n_frontend_tokens: int = 0   # vision: patch tokens prepended
    # --- numerics / misc ---
    param_dtype: str = "bfloat16"
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    optimizer: str = "adamw"     # adamw | adafactor (multi-hundred-B MoEs)
    remat: str = "full"          # full | dots | none | boundaries
    tp_mlp: bool = False         # tensor-parallel MLP (the sharding slice)
    moe_impl: str = "psum"       # psum | a2a (the sharding slice)
    notes: str = ""

    # ------------------------------------------------------------------
    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_repeats(self) -> int:
        return self.n_layers // self.period

    @property
    def n_tail(self) -> int:
        return self.n_layers - self.n_repeats * self.period

    def layer_spec(self, i: int) -> LayerSpec:
        return self.layer_pattern[i % self.period]

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank if self.dt_rank else max(1, self.d_model // 16)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def moe_ff(self) -> int:
        return self.expert_ff if self.expert_ff else self.d_ff

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (Megatron-style; the pad
        columns' logits are masked to -1e30)."""
        return ((self.vocab_size + 255) // 256) * 256

    def param_count(self) -> int:
        """Total parameters (embeddings included, frontend stubs excluded)."""
        d = self.d_model
        total = self.vocab_size * d * 2          # embed + unembed
        for i in range(self.n_layers):
            spec = self.layer_spec(i)
            if spec.mixer in ("full", "swa"):
                total += d * (self.n_heads * self.head_dim)          # wq
                total += 2 * d * (self.n_kv_heads * self.head_dim)   # wk, wv
                total += (self.n_heads * self.head_dim) * d          # wo
            elif spec.mixer == "mamba":
                inner = self.ssm_inner
                total += d * 2 * inner                                # in_proj
                total += inner * self.ssm_conv                        # conv
                total += inner * (self.dt_rank_actual + 2 * self.ssm_state)
                total += self.dt_rank_actual * inner                  # dt_proj
                total += inner * self.ssm_state + inner               # A_log, D
                total += inner * d                                    # out_proj
            elif spec.mixer == "rwkv":
                total += 4 * d * d + d * d                            # r,k,v,g,o
                total += 2 * d * 64                                   # decay lora
            if spec.moe:
                total += self.n_experts * self._ffn_params(self.moe_ff)
                total += d * self.n_experts                           # router
                if self.dense_residual_ff:
                    total += self._ffn_params(self.dense_residual_ff)
            else:
                total += self._ffn_params(self.d_ff)
            total += 2 * d                                            # norms
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE top-k instead of all experts)."""
        if self.n_experts == 0:
            return self.param_count()
        total = self.param_count()
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.layer_spec(i).moe)
        total -= (self.n_experts - self.top_k) * n_moe_layers \
            * self._ffn_params(self.moe_ff)
        return total

    def _ffn_params(self, ff: int) -> int:
        gated = self.mlp_type in ("swiglu", "geglu")
        return self.d_model * ff * (3 if gated else 2)

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests."""
        period = self.period
        n_layers = max(period, 2 if period == 1 else period)
        small_heads = 4
        head_dim = 16
        d_model = small_heads * head_dim
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=d_model,
            n_heads=small_heads,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=head_dim,
            d_ff=128,
            expert_ff=64 if self.n_experts else 0,
            dense_residual_ff=64 if self.dense_residual_ff else 0,
            vocab_size=512,
            n_experts=4 if self.n_experts else 0,
            window=min(self.window, 8) if self.window else 0,
            ssm_state=8,
            ssm_expand=2,
            dt_rank=8,
            rwkv_head_dim=16,
            n_frontend_tokens=4 if self.n_frontend_tokens else 0,
            param_dtype="float32",
            remat="none",
        )


# Shape cells assigned to every LM arch (seq_len, global_batch, step kind).
SHAPES = {
    "train_4k":    dict(seq_len=4096,   batch=256, step="train"),
    "prefill_32k": dict(seq_len=32768,  batch=32,  step="prefill"),
    "decode_32k":  dict(seq_len=32768,  batch=128, step="decode"),
    "long_500k":   dict(seq_len=524288, batch=1,   step="decode"),
}


def is_subquadratic(cfg: ArchConfig) -> bool:
    """True if no layer needs an unbounded full-attention KV cache."""
    return all(spec.mixer != "full" for spec in cfg.layer_pattern)


def long_context_capable(cfg: ArchConfig) -> bool:
    """long_500k policy: run for archs whose sequence mixing is
    sub-quadratic (SSM/hybrid/SWA-dominant); skip pure full-attention."""
    kinds = {spec.mixer for spec in cfg.layer_pattern}
    if kinds == {"full"}:
        return False
    return True
