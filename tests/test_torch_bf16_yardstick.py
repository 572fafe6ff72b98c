"""The yardstick ``chip_smoke.py`` holds two bf16 runs of one model to
(ROADMAP C.19), on synthetic logits.

A sharded bf16 serving run and the single-device bf16 run each lie
inside the bf16 band around the f32 run of the same parameters at every
step, which bounds the two apart by the sum of their two bands (triangle
inequality): how far apart they lie is reported, not checked again.
The earlier check held one bf16 run against the other as if it were
exact, and so failed a pair that each lie inside their band.

* The shape of a measured four-card result (ROADMAP C.19) passes: the
  sharded run at 0.943 of its band around f32, the single-device run at
  0.973, the two apart by 1.113 of one band — which the earlier yardstick
  (one bf16 run taken as the truth) failed.
* A run past its band around f32 fails, whichever run it is.
* A pair apart by more than the sum of its bands fails: at least one
  of the two runs lies past its own band.
* A value that is not finite fails.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels.precision import TOLERANCES

ROOT = Path(__file__).resolve().parents[1]
VOCAB, ROWS, STEPS = 96, 4, 5
CASE = dict(key="full", arch="llama3.2-3b", reduced=True)


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _truth(seed: int = 0):
    """Each step's f32 logits (padded past the real vocab) and its band."""
    rng = np.random.default_rng(seed)
    tol = TOLERANCES["bf16"]
    steps, bands = [], []
    for _ in range(STEPS):
        t = rng.normal(0.0, 3.0, (ROWS, VOCAB + 8)).astype(np.float32)
        real = t[:, :VOCAB]
        bands.append(tol["atol"] * max(1.0, float(np.abs(real).max()))
                     + tol["rtol"] * np.abs(real))
        steps.append(t)
    return steps, bands


def _moved(truth, bands, at: dict):
    """Copies of ``truth`` with logit (row 0, col j) of step s moved by
    ``share`` of its band, for each (s, j) -> share in ``at``; the other
    logits moved by a tenth of theirs."""
    out = []
    for s, (t, b) in enumerate(zip(truth, bands)):
        x = t.copy()
        x[:, :VOCAB] += 0.1 * b
        for (step, j), share in at.items():
            if step == s:
                x[0, j] = t[0, j] + share * b[0, j]
        out.append(x)
    return out


def _runs(res, plain, truth):
    return ({"logits": res}, {"logits": plain}, {"logits": truth})


def test_the_four_card_shape_passes_the_new_yardstick_not_the_old(cs):
    truth, bands = _truth()
    sharded = _moved(truth, bands, {(2, 5): 0.943})
    single = _moved(truth, bands, {(2, 5): -0.17, (3, 7): 0.973})
    got = cs._held_bf16_against_f32(*_runs(sharded, single, truth), CASE,
                                    "(c) synthetic")
    assert max(got["sharded"]["shares"]) == pytest.approx(0.943, rel=1e-5)
    assert max(got["single-device"]["shares"]) == pytest.approx(0.973,
                                                                rel=1e-5)
    # the pair, 1.113 bands apart, against the sum of the two
    assert max(got["pair"]["shares"]) == pytest.approx(1.113 / 2, rel=1e-5)
    assert not any(n for v in got.values() for n in v.get("outside", []))
    # the earlier yardstick: the single-device bf16 run as the truth
    old = cs.bf16_against_f32({"sharded": sharded, "single-device": single},
                              single, VOCAB)
    assert sum(old["sharded"]["outside"]) >= 1
    assert max(old["sharded"]["shares"]) > 1.0


@pytest.mark.parametrize("which", ["sharded", "single-device"])
def test_a_run_outside_its_band_around_f32_fails(cs, which):
    truth, bands = _truth(1)
    bad = _moved(truth, bands, {(4, 11): 1.2})
    good = _moved(truth, bands, {})
    res, plain = (bad, good) if which == "sharded" else (good, bad)
    got = cs.bf16_against_f32({"sharded": res, "single-device": plain},
                              truth, VOCAB)
    assert got[which]["outside"] == [0, 0, 0, 0, 1]
    with pytest.raises(cs.SmokeFailure, match="bf16 yardstick"):
        cs._held_bf16_against_f32(*_runs(res, plain, truth), CASE, "(c)")


def test_a_pair_apart_by_more_than_the_sum_of_its_bands_fails(cs):
    truth, bands = _truth(2)
    res = _moved(truth, bands, {(1, 3): 1.05})
    plain = _moved(truth, bands, {(1, 3): -1.05})
    got = cs.bf16_against_f32({"sharded": res, "single-device": plain},
                              truth, VOCAB)
    assert max(got["pair"]["shares"]) == pytest.approx(1.05, rel=1e-5)
    assert got["sharded"]["outside"] == got["single-device"]["outside"] \
        == [0, 1, 0, 0, 0]
    with pytest.raises(cs.SmokeFailure,
                       match="'sharded': \\[1\\], 'single-device': \\[1\\]"):
        cs._held_bf16_against_f32(*_runs(res, plain, truth), CASE, "(c)")


def test_a_value_that_is_not_finite_fails(cs):
    truth, bands = _truth(3)
    res = _moved(truth, bands, {})
    res[0][1, 2] = np.nan
    got = cs.bf16_against_f32({"sharded": res,
                               "single-device": _moved(truth, bands, {})},
                              truth, VOCAB)
    assert got["sharded"]["outside"] == [1, 0, 0, 0, 0]
    assert not any(got["single-device"]["outside"])
    # columns past the real vocab are not held
    pad = _moved(truth, bands, {})
    pad[0][0, VOCAB + 1] = np.inf
    got = cs.bf16_against_f32({"sharded": pad, "single-device": pad}, truth,
                              VOCAB)
    assert not any(n for v in got.values() for n in v.get("outside", []))
