"""The port's training step (``repro_torch.train.train_step``) held against
the JAX package's ``repro.train.train_step``, all ten architectures at
their ``reduced()`` sizes, f32, on the CPU; the weights cross through
``convert``, the batches are the JAX package's ``SyntheticPipeline``'s
(numpy, seed 0).

* ``cross_entropy`` and ``fused_unembed_ce``: values and gradients equal
  the reference's and the naive loss's at rtol 1e-4 / atol 1e-5
  (``tests/test_optimizations.py``'s cases, ignored labels included); at
  ``padded_vocab >= 65536`` ``loss_fn`` takes the fused path.
* ``loss_fn``'s loss, ce and aux and every gradient leaf equal the
  reference's ``jax.value_and_grad`` at atol 1e-5 / rtol 1e-4; for the
  Mamba and RWKV scans (jamba, rwkv6) atol 5e-5, since their sequential
  recurrences sum in another order over the 16 steps.
* Two ``make_train_step`` steps (peak_lr 1e-3, warmup 2): loss, grad
  norm, lr, ce and aux agree at rtol 1e-5 (grad norm 1e-4). Step 0 has
  lr 0, so only the second step moves the parameters; that update is
  held by feeding the reference's clipped step-2 gradients to both
  optimizers from the reference's step-1 state: parameters within rtol
  1e-6 and atol 1e-6 of the lr, the state within rtol 1e-6 (atol
  1e-12). AdamW's m/sqrt(v) turns gradient noise near zero into O(1)
  differences, so the port's own step-2 parameters are only checked to
  have moved. ``microbatches=2`` against the reference's scan.
* Remat ("full", "dots", "boundaries") gives bitwise the loss and the
  gradients of "none" on the CPU: it changes what is kept, not what is
  computed.
* Serving is untouched: the parameters of ``init_params`` carry no
  gradient, prefill / decode / the hidden features carry no ``grad_fn``,
  and their logits on a fresh ``init_params`` are bitwise the same
  before and after a training step on another state.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.data.synthetic import SyntheticPipeline as JPipeline
from repro.models import transformer as jtr
from repro.optim import adafactor as jafac
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.models import transformer as ttr
from repro_torch.optim import adafactor, adamw
from repro_torch.train import train_step as tts
from repro_torch.train.serve_step import make_decode, make_prefill
from repro_torch.utils.tree import leaves, map_tree, unflatten

ARCH_IDS = sorted(JARCHS)
ATOL, RTOL = 1e-5, 1e-4
SCAN_ATOL = 5e-5                  # jamba (Mamba), rwkv6 (RWKV)
B, S = 2, 16
STEP_KW = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these models are small, and torch's threads
    spin at each op's barrier when pytest-xdist workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol,
                               err_msg=what)


def _batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _same_leaves(got, ref, what, **kw):
    ref_l = jax.tree_util.tree_leaves_with_path(ref)
    got_l = jax.tree.leaves(got)
    assert len(got_l) == len(ref_l), what
    for (path, b), a in zip(ref_l, got_l):
        assert np.shape(a) == np.shape(b), (what, path)
        _close(a, b, f"{what}{jax.tree_util.keystr(path)}", **kw)


@functools.lru_cache(maxsize=None)
def _reference(arch: str) -> dict:
    """The JAX side of one arch, computed once: params, two batches, the
    loss and gradients at the initial params for both (the parameters do
    not move at step 0), and two jitted train steps."""
    jcfg = JARCHS[arch].reduced()
    p = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    pipe = JPipeline(jcfg, batch=B, seq_len=S, seed=0)
    batches = [pipe.next_batch() for _ in range(2)]
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jts.loss_fn(p, jcfg, b, lambda x, k: x), has_aux=True))
    grads = [vg(p, b) for b in batches]
    step = jax.jit(jts.make_train_step(jcfg, **STEP_KW))
    st0 = jts.init_train_state(jcfg, p)
    st1, m1 = step(st0, batches[0])
    st2, m2 = step(st1, batches[1])
    np_ = functools.partial(jax.tree.map, np.asarray)
    return {"params": np_(p), "batches": batches,
            "grads": [np_(g) for g in grads], "states": [np_(st1),
                                                         np_(st2)],
            "metrics": [np_(m1), np_(m2)]}


def _port(arch, **kw):
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **kw)
    return cfg, convert.param_tree_from_numpy(
        _reference(arch)["params"], cfg, device="cpu")


def _scan_atol(arch):
    return SCAN_ATOL if arch.startswith(("jamba", "rwkv")) else ATOL


# -- the losses -------------------------------------------------------------

def _ce_case(seed, V=4096, vocab=4000, d=32, shape=(2, 6), ignore=()):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(shape + (d,)).astype(np.float32)
    W = (0.1 * rng.standard_normal((d, V))).astype(np.float32)
    lb = rng.integers(0, vocab, shape).astype(np.int32)
    for i in ignore:
        lb.flat[i] = tts.IGNORE_LABEL
    return h, W, lb


@pytest.mark.parametrize("ignore", [(), (1, 3, 7)])
def test_fused_ce_matches_the_naive_loss_and_the_reference(ignore):
    h, W, lb = _ce_case(0, ignore=ignore)
    V, vocab, chunk = 4096, 4000, 512
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(W).requires_grad_(True)
    tl = torch.from_numpy(lb)
    cols = torch.arange(V) < vocab
    naive = tts.cross_entropy(torch.where(cols, th @ tw, -1e30), tl)
    g_naive = torch.autograd.grad(naive, (th, tw))
    fused = tts.fused_unembed_ce(th, tw, tl, vocab_size=vocab, chunk=chunk)
    g_fused = torch.autograd.grad(fused, (th, tw))
    _close(fused, naive, "fused vs naive")
    for a, b, n in zip(g_fused, g_naive, ("hidden", "unembed")):
        _close(a, b, f"fused vs naive d/d{n}")

    def jnaive(h, W):
        return jts.cross_entropy(
            jnp.where(jnp.arange(V) < vocab, h @ W, -1e30), lb)

    def jfused(h, W):
        return jts.fused_unembed_ce(h, W, lb, vocab_size=vocab, chunk=chunk)

    for f, got, g_got in ((jnaive, naive, g_naive),
                          (jfused, fused, g_fused)):
        val, grads = jax.value_and_grad(f, argnums=(0, 1))(h, W)
        _close(got, val, f"{f.__name__} value")
        for a, b in zip(g_got, grads):
            _close(a, b, f"{f.__name__} gradient")


@pytest.mark.parametrize("V,chunk", [(4096, 512), (4000, 512), (1000, 300),
                                     (512, 16384)])
def test_fused_ce_takes_the_reference_chunk_count(V, chunk):
    nc = max(1, (V + chunk - 1) // chunk)
    while V % nc:
        nc += 1
    assert tts._chunks(V, chunk) == (nc, V // nc)
    h, W, lb = _ce_case(1, V=V, vocab=V - 3, shape=(1, 5))
    got = tts.fused_unembed_ce(torch.from_numpy(h), torch.from_numpy(W),
                               torch.from_numpy(lb), vocab_size=V - 3,
                               chunk=chunk)
    want = jts.fused_unembed_ce(h, W, lb, vocab_size=V - 3, chunk=chunk)
    _close(got, want, f"V={V} chunk={chunk}")


def test_all_ignored_labels_give_zero_loss_and_gradient():
    h, W, lb = _ce_case(2, shape=(1, 4), ignore=range(4))
    th = torch.from_numpy(h).requires_grad_(True)
    loss = tts.fused_unembed_ce(th, torch.from_numpy(W),
                                torch.from_numpy(lb), vocab_size=4000,
                                chunk=512)
    (g,) = torch.autograd.grad(loss, (th,))
    assert float(loss) == 0.0 and not bool(g.any())


def test_loss_fn_takes_the_fused_path_at_a_large_vocab(monkeypatch):
    arch = "llama3.2-3b"
    kw = dict(vocab_size=tts.FUSED_CE_MIN_VOCAB, n_layers=1)
    jcfg = dataclasses.replace(JARCHS[arch].reduced(), **kw)
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **kw)
    p = jtr.init_params(jcfg, jax.random.PRNGKey(1))
    b = JPipeline(jcfg, batch=1, seq_len=8, seed=3).next_batch()
    (jl, jx), jg = jax.value_and_grad(jts.loss_fn, has_aux=True)(
        p, jcfg, b, lambda x, k: x)
    calls = []
    monkeypatch.setattr(tts, "fused_unembed_ce", lambda *a, **k: calls.append(
        1) or tts._FusedUnembedCE.apply(*a, k["vocab_size"], 16384))
    params = convert.param_tree_from_numpy(jax.tree.map(np.asarray, p), cfg,
                                           device="cpu")
    live = map_tree(lambda t: t.requires_grad_(True), params)
    loss, extras = tts.loss_fn(live, cfg, _batch(b))
    gs = torch.autograd.grad(loss, leaves(live))
    assert calls == [1]
    _close(loss, jl, "loss")
    _same_leaves(convert.param_tree_to_numpy(unflatten(live, gs)), jg,
                 "grad")


# -- loss and gradients, every arch -----------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_gradients_match_the_reference(arch):
    ref = _reference(arch)
    cfg, params = _port(arch)
    (jl, jx), jg = ref["grads"][0]
    live = map_tree(lambda t: t.requires_grad_(True), params)
    loss, extras = tts.loss_fn(live, cfg, _batch(ref["batches"][0]))
    gs = torch.autograd.grad(loss, leaves(live), allow_unused=True)
    gs = [torch.zeros_like(t) if g is None else g
          for t, g in zip(leaves(live), gs)]
    _close(loss, jl, "loss")
    for k in ("ce", "aux"):
        _close(extras[k], jx[k], k)
    _same_leaves(convert.param_tree_to_numpy(unflatten(live, gs)), jg,
                 f"{arch} grad", atol=_scan_atol(arch))


# -- two train steps, every arch --------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_two_steps_match_the_reference(arch):
    ref = _reference(arch)
    cfg, params = _port(arch)
    before = [t.clone() for t in leaves(params)]
    state = tts.init_train_state(cfg, params)
    step = tts.make_train_step(cfg, **STEP_KW)
    for i, b in enumerate(ref["batches"]):
        state, m = step(state, _batch(b))
        want = ref["metrics"][i]
        assert set(m) == set(want) == {"loss", "grad_norm", "lr", "ce",
                                       "aux"}
        for k in want:
            _close(m[k], want[k], f"step {i} {k}", atol=1e-6,
                   rtol=1e-4 if k == "grad_norm" else 1e-5)
    assert float(ref["metrics"][0]["lr"]) == 0.0
    assert int(state.step) == 2
    assert any(not torch.equal(a, b)
               for a, b in zip(before, leaves(state.params)))

    # the second update: the reference's clipped step-2 gradients through
    # both optimizers from the reference's step-1 state
    jst1 = ref["states"][0]
    st1 = convert.train_state_from_numpy(jst1, cfg, device="cpu")
    lr = np.asarray(ref["metrics"][1]["lr"])
    jopt = jafac if cfg.optimizer == "adafactor" else jadamw

    # eager, op by op as written (under jit XLA may contract the moments'
    # b * m + (1 - b) * g into one rounding)
    g2, _ = jts.clip_by_global_norm(ref["grads"][1][1], 1.0)
    g2 = jax.tree.map(np.asarray, g2)
    want_p, want_o = jopt.update(g2, jst1.opt_state, jst1.params, lr=lr)
    opt = adafactor if cfg.optimizer == "adafactor" else adamw
    new_p, new_o = opt.update(convert.param_tree_from_numpy(
        g2, cfg, device="cpu"), st1.opt_state, st1.params,
        lr=torch.from_numpy(lr))
    got = convert.train_state_to_numpy(tts.TrainState(new_p, new_o,
                                                      st1.step), cfg)
    _same_leaves(got.params, want_p, f"{arch} step-2 params",
                 atol=1e-6 * float(lr), rtol=1e-6)
    for f in want_o._fields:
        if f != "step":
            _same_leaves(getattr(got.opt_state, f), getattr(want_o, f),
                         f"{arch} {f}", atol=1e-12, rtol=1e-6)


def test_microbatches_match_the_reference_scan():
    arch = "llama3.2-3b"
    jcfg = JARCHS[arch].reduced()
    ref = _reference(arch)
    b = JPipeline(jcfg, batch=4, seq_len=S, seed=5).next_batch()
    jstep = jax.jit(jts.make_train_step(jcfg, microbatches=2, **STEP_KW))
    _, want = jstep(jts.init_train_state(jcfg, ref["params"]), b)
    cfg, params = _port(arch)
    step = tts.make_train_step(cfg, microbatches=2, **STEP_KW)
    state, got = step(tts.init_train_state(cfg, params), _batch(b))
    for k in ("loss", "grad_norm", "lr", "ce", "aux"):
        _close(got[k], want[k], f"microbatches {k}", atol=1e-6, rtol=1e-5)
    assert float(got["aux"]) == 0.0 and float(got["ce"]) == float(
        got["loss"])


# -- remat --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _loss_and_grads(arch: str, remat: str):
    cfg, params = _port(arch, remat=remat)
    live = map_tree(lambda t: t.requires_grad_(True), params)
    loss, _ = tts.loss_fn(live, cfg, _batch(_reference(arch)["batches"][0]))
    return loss.detach(), torch.autograd.grad(loss, leaves(live),
                                              allow_unused=True)


@pytest.mark.parametrize("arch,remat", [
    (arch, remat) for arch in ("llama3.2-3b", "mixtral-8x22b", "rwkv6-7b")
    for remat in ("full", "dots", "boundaries")]
    + [("jamba-1.5-large-398b", "full")])
def test_remat_changes_no_value(arch, remat):
    loss, grads = _loss_and_grads(arch, remat)
    loss0, grads0 = _loss_and_grads(arch, "none")
    assert torch.equal(loss, loss0)
    assert len(grads) == len(grads0)
    for a, b in zip(grads, grads0):
        assert (a is None and b is None) or torch.equal(a, b)


def test_remat_keeps_less_than_none():
    """"full" keeps each layer's input only, "none" every intermediate."""
    arch = "llama3.2-3b"
    kept = {}
    for remat in ("none", "full"):
        cfg, params = _port(arch, remat=remat)
        live = map_tree(lambda t: t.requires_grad_(True), params)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.numel()) or t, lambda t: t):
            tts.loss_fn(live, cfg, _batch(_reference(arch)["batches"][0]))
        kept[remat] = sum(saved)
    assert kept["full"] < kept["none"]


# -- serving untouched ---------------------------------------------------------

def _serve(cfg, params, tokens):
    cache = ttr.init_cache(cfg, tokens.shape[0], tokens.shape[1] + 1,
                           device="cpu")
    logits, cache = make_prefill(cfg)(params, cache, {"tokens": tokens})
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    step, _ = make_decode(cfg)(params, cache, tok)
    hidden, _, _ = ttr.forward(params, cfg, tokens=tokens,
                               return_hidden=True)
    return logits, step, hidden


def test_serving_is_untouched_by_training():
    cfg = ARCHS["llama3.2-3b"]
    cfg = dataclasses.replace(cfg.reduced(), remat="full")
    fresh = lambda: ttr.init_params(                      # noqa: E731
        cfg, torch.Generator().manual_seed(7), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 6),
                           generator=torch.Generator().manual_seed(1))
    before = _serve(cfg, fresh(), tokens)
    trained = fresh()
    assert not any(p.requires_grad for p in trained.parameters())
    state = tts.init_train_state(cfg, trained)
    step = tts.make_train_step(cfg, peak_lr=1e-2, warmup_steps=1)
    pipe_b = JPipeline(JARCHS["llama3.2-3b"].reduced(), batch=2, seq_len=8,
                       seed=0)
    for _ in range(2):
        state, _ = step(state, _batch(pipe_b.next_batch()))
    assert not any(p.requires_grad for p in trained.parameters())
    after = _serve(cfg, fresh(), tokens)
    for a, b in zip(before, after):
        assert a.grad_fn is None and b.grad_fn is None
        assert torch.equal(a, b)
    # the trained Decoder shares the state's tensors: it serves the
    # trained weights, still without a graph
    moved = _serve(cfg, trained, tokens)
    assert all(t.grad_fn is None for t in moved)
    assert not torch.equal(moved[0], before[0])
