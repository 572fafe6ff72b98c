"""The plain reference against a float64 loop, and its rounding."""
import math

import numpy as np
import pytest
import torch

from reference import slab as ref


def loop_decision(q, t, gamma, rho1, rho2, kgamma):
    out = []
    for x in q:
        s = 0.0
        for row, g in zip(t, gamma):
            s += g * math.exp(-kgamma * sum((a - b) ** 2
                                            for a, b in zip(x, row)))
        out.append((s - rho1) * (rho2 - s))
    return np.array(out)


@pytest.mark.parametrize("block", [None, 1, 3])
def test_decision_matches_a_float64_loop(block):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((7, 5)).astype(np.float32)
    t = rng.standard_normal((11, 5)).astype(np.float32)
    g = rng.uniform(-0.1, 0.2, 11).astype(np.float32)
    want = loop_decision(q.astype(np.float64), t.astype(np.float64),
                         g.astype(np.float64), 0.05, 0.4, 0.2)
    got = ref.decision(torch.from_numpy(q), torch.from_numpy(t),
                       torch.from_numpy(g), 0.05, 0.4, 0.2, block=block)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


def test_round_rows_tf32_keeps_ten_mantissa_bits_to_nearest_even():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11 + 2 ** -20), 3.0e-30, -7.5],
                     dtype=torch.float32)
    got = ref.round_rows(x, "tf32").tolist()
    assert got[0] == 1.0 + 2 ** -10          # representable
    assert got[1] == 1.0                     # tie, to even
    assert got[2] == 1.0 + 2 ** -9           # tie, to even (up)
    assert got[3] == -(1.0 + 2 ** -10)       # above the tie: up in size
    assert got[5] == -7.5
    bits = ref.round_rows(torch.randn(1000), "tf32").to(torch.float32)
    assert (bits.view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("precision,dtype", [("bf16", torch.bfloat16),
                                             ("fp8", torch.float8_e4m3fn)])
def test_round_rows_16_and_8_bit(precision, dtype):
    x = torch.randn(257)
    want = x.to(dtype).to(torch.float64)
    assert torch.equal(ref.round_rows(x, precision), want)
    assert torch.equal(ref.round_rows(x, "f32"), x.to(torch.float64))


def test_round_rows_refuses_an_unknown_precision():
    with pytest.raises(ValueError):
        ref.round_rows(torch.ones(2), "int4")
