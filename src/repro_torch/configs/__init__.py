"""Published configurations the port runs: the paper's own
(``ocssvm_paper``) and the LM architectures (``--arch <id>`` ->
``ArchConfig``), field for field the JAX package's."""
from repro_torch.configs.base import (ArchConfig, LayerSpec, SHAPES,
                                      is_subquadratic, long_context_capable)
from repro_torch.configs.llama3_2_3b import CONFIG as _llama
from repro_torch.configs.minitron_8b import CONFIG as _minitron
from repro_torch.configs.gemma3_27b import CONFIG as _gemma
from repro_torch.configs.deepseek_coder_33b import CONFIG as _deepseek
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.jamba_1_5_large import CONFIG as _jamba
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv
from repro_torch.configs.internvl2_26b import CONFIG as _internvl

ARCHS = {c.name: c for c in (
    _llama, _minitron, _gemma, _deepseek, _musicgen,
    _arctic, _mixtral, _jamba, _rwkv, _internvl)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "LayerSpec", "SHAPES", "ARCHS", "get_arch",
           "is_subquadratic", "long_context_capable"]
