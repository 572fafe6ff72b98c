"""The analytic inventory of ``repro_torch.utils.roofline`` against the JAX
package's ``repro.utils.roofline``: ``model_flops``, ``model_hbm_bytes``
(fsdp on and off, on 256 and 512 chips), ``_cache_bytes`` and
``_attn_context`` equal the reference's on every arch x ``SHAPES`` cell
(40 cells) at rel 1e-12 — the same arithmetic on the port's own
``ArchConfig``. ``mfu_fraction`` is the reference's with the H100 peak of
the precision in place of the TPU's.
"""
import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs.base import SHAPES as JSHAPES
from repro.utils import roofline as jroofline
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.utils import roofline

ARCH_IDS = sorted(ARCHS)
REL = 1e-12


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_inventory_matches_the_reference(arch, shape):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    assert SHAPES[shape] == JSHAPES[shape]
    assert roofline.model_flops(cfg, shape) == pytest.approx(
        jroofline.model_flops(jcfg, shape), rel=REL)
    for chips in (256, 512):
        for fsdp in (True, False):
            assert roofline.model_hbm_bytes(
                cfg, shape, chips, fsdp=fsdp) == pytest.approx(
                jroofline.model_hbm_bytes(jcfg, shape, chips, fsdp=fsdp),
                rel=REL)
    sh = SHAPES[shape]
    B, S = sh["batch"], sh["seq_len"]
    assert roofline._cache_bytes(cfg, B, S) == pytest.approx(
        jroofline._cache_bytes(jcfg, B, S), rel=REL)
    for mixer in ("full", "swa"):
        for decode in (False, True):
            assert roofline._attn_context(
                cfg, mixer, S, decode_pos=S, decode=decode) == pytest.approx(
                jroofline._attn_context(jcfg, mixer, S, decode_pos=S,
                                        decode=decode), rel=REL)


@pytest.mark.parametrize("precision", ["f32", "bf16", "f16"])
def test_mfu_fraction_uses_the_peak_of_its_precision(precision):
    t = roofline.terms(3e15, 1e12, 5e11, chips=8, precision=precision)
    bound = max(t.compute_s, t.memory_s, t.collective_s)
    assert roofline.mfu_fraction(t, 1e15, precision) == pytest.approx(
        1e15 / (8 * roofline.PEAK_FLOPS[precision] * bound), rel=REL)
    # the reference's formula, its peak swapped for the H100's
    jt = jroofline.terms(3e15, 1e12, 5e11, 8)
    jt.compute_s, jt.memory_s, jt.collective_s = (t.compute_s, t.memory_s,
                                                  t.collective_s)
    assert roofline.mfu_fraction(t, 1e15, precision) == pytest.approx(
        jroofline.mfu_fraction(jt, 1e15) * jroofline.V5E["peak_flops"]
        / roofline.PEAK_FLOPS[precision], rel=REL)
    assert roofline.mfu_fraction(roofline.terms(0.0, 0.0), 1.0) == 0.0
