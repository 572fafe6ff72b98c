"""The port's optimizers and LR schedules (``repro_torch.optim``) held
against the JAX package's ``repro.optim``.

* AdamW and Adafactor converge on ``tests/test_substrate.py``'s quadratic
  (the same bound, 0.05, after 200 steps at lr 0.05).
* Adafactor's state has the reference's shapes, on a flat tree and on the
  stacked LM trees: a per-layer norm (d,) is a factored (R, d) leaf there
  (ROADMAP C.16).
* ``warmup_cosine`` equals the reference's at steps 0..100 to 1 ulp of
  f32 (the port rounds its cosine once from f64; ``jnp.cos`` is
  correctly rounded here, ``torch.cos`` in f32 can be 1 ulp off).
* Given the same numpy gradients, two updates give the reference's new
  parameters and state within rtol 1e-6, for every leaf of every reduced
  arch's tree: Adafactor for arctic and jamba, AdamW for the other
  eight. A parameter's atol is 1e-6 of the two steps' summed lr (the
  scale of its update: Adafactor clips the update's RMS to 1, AdamW's
  m/sqrt(v) is about 1), for the entries the update leaves near zero;
  the state's is 1e-12. f32 on both sides; the order of a mean's sum and
  the last bit of rsqrt differ.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import transformer as jtr
from repro.optim import adafactor as jafac
from repro.optim import adamw as jadamw
from repro.optim.schedules import constant as jconstant
from repro.optim.schedules import warmup_cosine as jwarmup_cosine
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.optim import adafactor, adamw
from repro_torch.optim.schedules import constant, warmup_cosine
from repro_torch.train.train_step import TrainState, init_train_state
from repro_torch.utils.tree import Stacked

ARCH_IDS = sorted(JARCHS)
RTOL, ATOL = 1e-6, 1e-12
LRS = (1e-3, 5e-4)          # the two updates' learning rates



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these models are small, and torch's threads
    spin at each op's barrier when pytest-xdist workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# -- convergence and state shapes -------------------------------------------

def _quadratic_steps(opt, n=200, lr=0.1):
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = opt.init(params)
    for _ in range(n):
        grads = {"w": 2.0 * params["w"]}     # d/dw ||w||^2
        params, state = opt.update(grads, state, params, lr=lr)
    return float(params["w"].abs().max())


def test_adamw_converges_quadratic():
    assert _quadratic_steps(adamw, lr=0.05) < 0.05


def test_adafactor_converges_quadratic():
    assert _quadratic_steps(adafactor, lr=0.05) < 0.05


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros((64, 32)), "b": torch.zeros((64,))}
    st = adafactor.init(params)
    ref = jafac.init({"w": jnp.zeros((64, 32)), "b": jnp.zeros((64,))})
    for tree, jtree in ((st.vr, ref.vr), (st.vc, ref.vc)):
        assert {k: tuple(v.shape) for k, v in tree.items()} == \
            {k: tuple(v.shape) for k, v in jtree.items()}
    assert st.vr["w"].shape == (64,) and st.vc["w"].shape == (32,)


@pytest.mark.parametrize("arch", ["arctic-480b", "jamba-1.5-large-398b",
                                  "llama3.2-3b"])
def test_adafactor_state_follows_the_stacked_tree(arch):
    jcfg, cfg = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    cfg = dataclasses.replace(cfg, optimizer="adafactor")
    p = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    ref = jafac.init(p)
    state = init_train_state(cfg, convert.param_tree_from_numpy(
        jax.tree.map(np.asarray, p), cfg, device="cpu"))
    mine = convert.train_state_to_numpy(state, cfg).opt_state
    for name in ("vr", "vc"):
        a, b = getattr(mine, name), getattr(ref, name)
        assert jax.tree.structure(a) == jax.tree.structure(
            jax.tree.map(np.asarray, b))
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert x.shape == y.shape and x.dtype == np.float32
    if cfg.n_repeats:
        R = cfg.n_repeats
        # the per-layer norm (d,) is a factored (R, d) leaf
        assert mine.vr["segments"]["l0"]["norm1"].shape == (R,)
        assert mine.vc["segments"]["l0"]["norm1"].shape == (cfg.d_model,)
        assert isinstance(state.params["segments"]["l0"]["norm1"], Stacked)
    if arch == "arctic-480b":
        assert cfg.n_repeats == 2 and cfg.period == 1


# -- schedules ----------------------------------------------------------------

def _ulps(a, b) -> int:
    return abs(int(np.float32(a).view(np.int32))
               - int(np.float32(b).view(np.int32)))


@pytest.mark.parametrize("peak,warmup,total", [
    (1.0, 10, 100), (1e-3, 2, 10), (3e-4, 100, 10_000), (1e-3, 0, 50),
    (1e-3, 7, 7)])
def test_warmup_cosine_matches_the_reference_to_one_ulp(peak, warmup,
                                                        total):
    for s in range(101):
        want = jwarmup_cosine(jnp.asarray(s, jnp.int32), peak_lr=peak,
                              warmup_steps=warmup, total_steps=total)
        got = warmup_cosine(torch.tensor(s, dtype=torch.int32),
                            peak_lr=peak, warmup_steps=warmup,
                            total_steps=total)
        assert got.dtype == torch.float32
        assert _ulps(got.numpy(), np.asarray(want)) <= 1, s
    assert float(warmup_cosine(torch.tensor(0), peak_lr=peak,
                               warmup_steps=max(warmup, 1),
                               total_steps=total)) == 0.0


def test_constant_schedule():
    got = constant(torch.tensor(5, dtype=torch.int32), peak_lr=3e-4)
    want = jconstant(jnp.asarray(5, jnp.int32), peak_lr=3e-4)
    assert got.dtype == torch.float32 and float(got) == float(want)


# -- one update against the reference, every arch's tree ---------------------

def _close(a, b, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=atol, err_msg=what)


def _grads(p, seed):
    """Numpy gradients shaped like the JAX tree, N(0, 1e-2)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (1e-2 * rng.standard_normal(a.shape))
                        .astype(np.float32), p)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_update_matches_the_reference(arch):
    jcfg, cfg = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    jopt = jafac if jcfg.optimizer == "adafactor" else jadamw
    opt = adafactor if cfg.optimizer == "adafactor" else adamw
    assert (cfg.optimizer == "adafactor") == (arch in (
        "arctic-480b", "jamba-1.5-large-398b"))
    p = jax.tree.map(np.asarray, jtr.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    jstate = jts.init_train_state(jcfg, p)
    state = convert.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                           cfg, device="cpu")
    jp, jo, params, ost = jstate.params, jstate.opt_state, state.params, \
        state.opt_state
    for i, lr in enumerate(LRS):
        g = _grads(p, i)
        # eager, op by op as written: under jit XLA may contract
        # b1 * m + (1 - b1) * g into one rounding
        jp, jo = jopt.update(g, jo, jp, lr=lr)
        params, ost = opt.update(convert.param_tree_from_numpy(
            g, cfg, device="cpu"), ost, params, lr=lr)
    mine = convert.train_state_to_numpy(TrainState(params, ost,
                                                   state.step), cfg)
    assert int(mine.opt_state.step) == int(jo.step) == 2
    ref = {"params": jp, **{f: getattr(jo, f) for f in jo._fields
                            if f != "step"}}
    got = {"params": mine.params, **{f: getattr(mine.opt_state, f)
                                     for f in jo._fields if f != "step"}}
    for name in ref:
        ref_l = jax.tree_util.tree_leaves_with_path(ref[name])
        got_l = jax.tree.leaves(got[name])
        assert len(got_l) == len(ref_l)
        for (path, b), a in zip(ref_l, got_l):
            assert a.shape == b.shape, (name, path)
            _close(a, b, f"{arch} {name}{jax.tree_util.keystr(path)}",
                   atol=RTOL * sum(LRS) if name == "params" else ATOL)
