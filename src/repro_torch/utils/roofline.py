"""Three-term roofline model of one NVIDIA H100 SXM card.

Terms (seconds):
    compute    = FLOPs / (chips * peak FLOP/s of the input type)
    memory     = HBM bytes / (chips * 3.35e12)
    collective = link bytes / (chips * 450e9)     [NVLink, each way]

The peaks are NVIDIA's data-sheet numbers for the SXM part, dense, at its
700 W limit: 67 TFLOP/s in f32 outside the tensor cores, 989 TFLOP/s in
bf16 and f16 on the tensor cores. A card set below 700 W runs slower under
load, so a share of these peaks is stated with the card's power limit.
The counterpart of the JAX package's ``utils/roofline``, whose peaks
are a TPU's; the peak depends on the input type here, so ``terms`` and
``mfu_fraction`` take the precision.

Beside the terms, the reference's analytic inventory of an LM step, the
same arithmetic on the port's ``ArchConfig`` and ``SHAPES``:
``model_flops`` (MODEL_FLOPS = 6 N_active T to train, 2 N_active T to
prefill or decode, plus the attention scores and values, which the 6N
rule misses) — the "useful work" yardstick beside the FLOPs
``utils.cost_analysis`` counts in the op stream, their ratio exposing
remat recompute and work replicated across ranks — and
``model_hbm_bytes``, the step's HBM traffic summed over the cards. The
byte counts assume bf16 parameters, activations and KV caches, as the
reference's do, whatever ``cfg.dtype`` is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import SHAPES, ArchConfig

HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "f16": 989e12}


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        # overlap model: perfectly overlapped => max; report max as the bound
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
        }


def terms(flops: float, hbm_bytes: float, coll_bytes: float = 0.0,
          chips: int = 1, precision: str = "f32") -> RooflineTerms:
    """The three terms of work on ``chips`` cards whose operations take
    inputs of ``precision`` ("f32", "bf16" or "f16")."""
    if precision not in PEAK_FLOPS:
        raise ValueError(f"unknown precision {precision!r}; expected one "
                         f"of {tuple(PEAK_FLOPS)}")
    return RooflineTerms(
        compute_s=flops / (chips * PEAK_FLOPS[precision]),
        memory_s=hbm_bytes / (chips * HBM_BYTES_PER_S),
        collective_s=coll_bytes / (chips * NVLINK_BYTES_PER_S),
        flops=flops, hbm_bytes=hbm_bytes, coll_bytes=coll_bytes, chips=chips)


# ---------------------------------------------------------------------------
# analytic inventory
# ---------------------------------------------------------------------------

def _attn_context(cfg: ArchConfig, mixer: str, seq_len: int,
                  decode_pos: int = 0, decode: bool = False) -> float:
    """Average visible context length per query position."""
    if decode:
        ctx = decode_pos
        if mixer == "swa" and cfg.window:
            ctx = min(ctx, cfg.window)
        return float(ctx)
    if mixer == "swa" and cfg.window and seq_len > cfg.window:
        # ramp up to the window, then constant
        w = cfg.window
        return (w * (w + 1) / 2 + (seq_len - w) * w) / seq_len
    return (seq_len + 1) / 2.0


def model_flops(cfg: ArchConfig, shape_name: str) -> float:
    """Analytic step FLOPs: 6*N_active*T train / 2*N_active*T decode,
    plus exact attention score/value FLOPs (the 6N rule misses them)."""
    sh = SHAPES[shape_name]
    S, B, step = sh["seq_len"], sh["batch"], sh["step"]
    n_active = cfg.active_param_count()
    decode = step == "decode"
    tokens = B * (1 if decode else S)
    mult = 2 if decode else (2 if step == "prefill" else 6)
    total = float(mult) * n_active * tokens

    # attention score+value FLOPs: 4 * ctx * (Hq * Dh) per token per layer
    bwd = 2 if step == "train" else 0   # bwd recomputes ~2x attn matmuls
    for i in range(cfg.n_layers):
        mixer = cfg.layer_spec(i).mixer
        if mixer not in ("full", "swa"):
            continue
        ctx = _attn_context(cfg, mixer, S, decode_pos=S, decode=decode)
        per_tok = 4.0 * ctx * cfg.n_heads * cfg.head_dim
        total += per_tok * tokens * (1 + bwd)
    return total


def model_hbm_bytes(cfg: ArchConfig, shape_name: str, chips: int,
                    *, fsdp: bool = True) -> float:
    """Analytic HBM traffic per step (global, all cards summed).

    Train: params read fwd+bwd + grads written + optimizer state r/w;
    activations written once per layer block and re-read in bwd (full
    remat => recomputed, still one write+read at block granularity).
    Decode: params read once + full KV/state cache read + small writes.
    ``chips`` and ``fsdp`` do not enter the sum (the reference's
    signature)."""
    sh = SHAPES[shape_name]
    S, B, step = sh["seq_len"], sh["batch"], sh["step"]
    p_bytes = cfg.active_param_count() * 2.0         # bf16
    d = cfg.d_model

    if step == "train":
        tokens = B * S
        act_block = tokens * d * 2.0                  # bf16 per layer block
        acts = act_block * cfg.n_layers * 2.0 * 2.0   # w+r, fwd+bwd(remat)
        opt = cfg.param_count() * (12.0 if cfg.optimizer == "adamw" else 1.0)
        return 3.0 * cfg.param_count() * 2.0 + opt + acts
    if step == "prefill":
        tokens = B * S
        acts = tokens * d * 2.0 * cfg.n_layers * 2.0
        cache = _cache_bytes(cfg, B, S)
        return p_bytes + acts + cache
    # decode
    cache = _cache_bytes(cfg, B, S)
    return p_bytes + cache + B * d * 2.0 * cfg.n_layers * 4.0


def _cache_bytes(cfg: ArchConfig, B: int, S: int) -> float:
    total = 0.0
    for i in range(cfg.n_layers):
        mixer = cfg.layer_spec(i).mixer
        if mixer == "full":
            total += 2.0 * B * S * cfg.n_kv_heads * cfg.head_dim * 2.0
        elif mixer == "swa":
            w = min(cfg.window or S, S)
            total += 2.0 * B * w * cfg.n_kv_heads * cfg.head_dim * 2.0
        elif mixer == "mamba":
            total += B * cfg.ssm_inner * cfg.ssm_state * 4.0
            total += B * (cfg.ssm_conv - 1) * cfg.ssm_inner * 2.0
        elif mixer == "rwkv":
            total += B * cfg.rwkv_heads * cfg.rwkv_head_dim ** 2 * 4.0
    return total


def mfu_fraction(t: RooflineTerms, useful_flops: float,
                 precision: str = "bf16") -> float:
    """Fraction of roofline: useful FLOPs / (chips * the peak of
    ``precision`` * the bound time)."""
    bound = t.step_time_s
    if bound <= 0:
        return 0.0
    return useful_flops / (t.chips * PEAK_FLOPS[precision] * bound)
