"""The scan operators (``repro_torch.kernels.scan``) on the CPU, held against
the JAX package.

* ``ssm_scan_plain`` (autograd through its checkpointed chunks) and the
  ``repro_torch::ssm_scan_fwd`` operator (its plain forward and its plain
  backward, each chunk recomputed from its carry under autograd)
  against ``repro.models.mamba._ssm_scan``: y, the last state and the
  gradient of every input (``jax.vjp`` against ``torch.autograd``) at
  S in {1, 5, 128, 131, 300}.
* ``wkv6_plain`` and ``repro_torch::wkv6_fwd`` the same way. The JAX
  package scans RWKV inside ``rwkv_time_mix`` and has no function of the
  scan alone, so its step (``src/repro/models/rwkv.py:96-103``) is
  scanned here by ``lax.scan`` over the real steps (ROADMAP C.13).
* ``mamba_forward`` and ``rwkv_time_mix`` (which call the operators)
  against the JAX package's, with a state and without: outputs, new
  state and the gradients of every weight, of x and of the state. The JAX
  RWKV state after a length above 128 and no multiple of it is the
  real-step state: the JAX package's prefix of whole chunks, then its
  tail, in two calls (C.13: one call would pad and wipe it).
* ``torch.library.opcheck`` on the four operators; on ``meta``, each
  layer dispatches one scan operator forward and one backward.
* ROADMAP C.20: the tensors autograd saves for backward at S = 2048 that
  are not the caller's inputs stay under (S / 128 + 128) states.
* Each FLOP formula equals the FLOPs ``utils.cost_analysis`` counts for
  the plain version's operations.

Tolerance: the f32 ``TOLERANCES`` (the reference's ``truth_tolerance``,
atol scaled by the largest reference value); both sides compute in f32
and differ in summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS as JARCHS
from repro.kernels.precision import truth_tolerance
from repro.models import mamba as jmam
from repro.models import rwkv as jrwkv
from repro_torch.configs import ARCHS
from repro_torch.kernels.scan import ops as sops
from repro_torch.kernels.scan import ref as sref
from repro_torch.models import mamba as tmam
from repro_torch.models import rwkv as trwkv
from repro_torch.utils.cost_analysis import analyze

SEQ = [1, 5, 128, 131, 300]


def _close(port, ref, what=""):
    ref = np.asarray(ref, np.float32)
    got = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(got, ref, err_msg=what,
                               **truth_tolerance("f32", ref))


def _rng_arrays(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch_vjp(fn, inputs, cotangents):
    """(outputs, gradients of every input) of fn through autograd."""
    ts = [torch.from_numpy(np.array(a)).requires_grad_() for a in inputs]
    outs = fn(*ts)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cotangents])
    return outs, [t.grad for t in ts]


def _jax_vjp(fn, inputs, cotangents):
    outs, pull = jax.vjp(fn, *[jnp.asarray(a) for a in inputs])
    return outs, pull(tuple(jnp.asarray(c) for c in cotangents))


# ---------------------------------------------------------------------------
# the scans alone
# ---------------------------------------------------------------------------

def _ssm_inputs(seed, S, bt=2, inner=16, N=8):
    rng = np.random.default_rng(seed)
    u, B, C = (rng.standard_normal(s).astype(np.float32)
               for s in ((bt, S, inner), (bt, S, N), (bt, S, N)))
    dt = rng.uniform(0.01, 0.3, (bt, S, inner)).astype(np.float32)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (inner, 1)) \
        * rng.uniform(0.5, 1.5, (inner, 1)).astype(np.float32)
    D = (1 + 0.1 * rng.standard_normal(inner)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((bt, inner, N))).astype(np.float32)
    return [u, dt, B, C, A, D, h0]


SCAN_PATHS = {"plain": (sref.ssm_scan_plain, sref.wkv6_plain),
              "op": (sops.ssm_scan, sops.wkv6)}


@pytest.mark.parametrize("path", sorted(SCAN_PATHS))
@pytest.mark.parametrize("S", SEQ)
def test_ssm_scan_matches_the_reference(S, path):
    ins = _ssm_inputs(S, S)
    bt, _, inner = ins[0].shape
    cots = _rng_arrays(S + 1, [(bt, S, inner), ins[6].shape])
    (y, h), grads = _torch_vjp(SCAN_PATHS[path][0], ins, cots)
    (jy, jh), jgrads = _jax_vjp(jmam._ssm_scan, ins, cots)
    _close(y, jy, "y")
    _close(h, jh, "h")
    for name, g, jg in zip(("u", "dt", "B", "C", "A", "D", "h0"), grads,
                           jgrads):
        _close(g, jg, f"d{name}")


def _jax_wkv(r, k, v, w, u, S0):
    """The JAX package's RWKV step, ``lax.scan``ned over the real steps."""
    def step(S, xs_t):
        r_t, k_t, v_t, w_t = xs_t
        kv = k_t[..., None] * v_t[..., None, :]
        y = jnp.einsum("bhd,bhde->bhe", r_t, S + u[None, :, :, None] * kv)
        return w_t[..., None] * S + kv, y
    S, ys = jax.lax.scan(step, S0, tuple(t.transpose(1, 0, 2, 3)
                                         for t in (r, k, v, w)))
    return ys.transpose(1, 0, 2, 3), S


def _wkv_inputs(seed, S, b=2, H=3, D=16):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, S, H, D)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-6, 0.5, (b, S, H, D)))) \
        .astype(np.float32)
    u = (0.1 * rng.standard_normal((H, D))).astype(np.float32)
    S0 = (0.5 * rng.standard_normal((b, H, D, D))).astype(np.float32)
    return [r, k, v, w, u, S0]


@pytest.mark.parametrize("path", sorted(SCAN_PATHS))
@pytest.mark.parametrize("S", SEQ)
def test_wkv6_matches_the_reference(S, path):
    ins = _wkv_inputs(S, S)
    cots = _rng_arrays(S + 1, [ins[0].shape, ins[5].shape])
    (y, S_last), grads = _torch_vjp(SCAN_PATHS[path][1], ins, cots)
    (jy, jS), jgrads = _jax_vjp(_jax_wkv, ins, cots)
    _close(y, jy, "y")
    _close(S_last, jS, "S")
    for name, g, jg in zip(("r", "k", "v", "w", "u", "S0"), grads, jgrads):
        _close(g, jg, f"d{name}")


def test_plain_backward_is_the_checkpointed_plain_version():
    """The operator's backward (each chunk recomputed from its carry, last
    chunk first) against autograd through the checkpointed plain
    versions, on the same inputs (chunk 4: many chunks, the last one
    short)."""
    for fwd, op_fwd, ins, names in (
            (sref.ssm_scan_plain, sops.ssm_scan, _ssm_inputs(3, 11),
             "u dt B C A D h0"),
            (sref.wkv6_plain, sops.wkv6, _wkv_inputs(4, 11),
             "r k v w u S0")):
        outs = fwd(*[torch.from_numpy(a) for a in ins])
        cots = _rng_arrays(5, [o.shape for o in outs])
        want, wgrads = _torch_vjp(lambda *t: fwd(*t, chunk=4), ins, cots)
        got, grads = _torch_vjp(lambda *t: op_fwd(*t, chunk=4), ins, cots)
        for a, b in zip(got, want):
            _close(a, b.detach().numpy())
        for name, g, w in zip(names.split(), grads, wgrads):
            _close(g, w.numpy(), f"d{name}")


# ---------------------------------------------------------------------------
# the layers that call them
# ---------------------------------------------------------------------------

def _cfgs(name):
    return JARCHS[name].reduced(), ARCHS[name].reduced()


def _leaves(params):
    names = sorted(params)
    return names, [np.asarray(params[n], np.float32) for n in names]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", SEQ)
def test_mamba_forward_matches_the_reference(S, with_state):
    jcfg, cfg = _cfgs("jamba-1.5-large-398b")
    p = jmam.mamba_init(jax.random.PRNGKey(S), jcfg, jnp.float32)
    names, leaves = _leaves(p)
    x = _rng_arrays(S, [(2, S, jcfg.d_model)])[0]
    st = []
    if with_state:
        st = _rng_arrays(S + 2, [(2, jcfg.ssm_conv - 1, jcfg.ssm_inner),
                                 (2, jcfg.ssm_inner, jcfg.ssm_state)])
        st[1] *= 0.5

    def port(*a):
        prm = dict(zip(names, a[:len(names)]))
        state = tmam.MambaState(*a[len(names) + 1:]) if with_state else None
        y, new = tmam.mamba_forward(prm, a[len(names)], cfg, state=state)
        return (y,) if new is None else (y, new.conv, new.h)

    def ref(*a):
        prm = dict(zip(names, a[:len(names)]))
        state = jmam.MambaState(*a[len(names) + 1:]) if with_state else None
        y, new = jmam.mamba_forward(prm, a[len(names)], jcfg, state=state)
        return (y,) if new is None else (y, new.conv, new.h)

    ins = leaves + [x] + st
    outs_np = [np.asarray(o) for o in ref(*map(jnp.asarray, ins))]
    cots = _rng_arrays(S + 3, [o.shape for o in outs_np])
    outs, grads = _torch_vjp(port, ins, cots)
    jouts, jgrads = _jax_vjp(ref, ins, cots)
    for o, jo in zip(outs, jouts):
        _close(o, jo)
    for name, g, jg in zip(names + ["x", "conv", "h"], grads, jgrads):
        _close(g, jg, f"d{name}")


def _jax_time_mix_real_steps(p, x, jcfg, state):
    """The JAX package's ``rwkv_time_mix`` with a state, scanning the real
    steps only: the prefix of whole 128-step chunks, then the tail."""
    S = x.shape[1]
    cut = S - S % 128 if S > 128 else 0
    if not cut or cut == S:
        return jrwkv.rwkv_time_mix(p, x, jcfg, state=state)
    y0, x_tm, wkv = jrwkv.rwkv_time_mix(p, x[:, :cut], jcfg, state=state)
    y1, x_tm, wkv = jrwkv.rwkv_time_mix(
        p, x[:, cut:], jcfg, state=state._replace(x_tm=x_tm, wkv=wkv))
    return jnp.concatenate([y0, y1], axis=1), x_tm, wkv


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", SEQ)
def test_rwkv_time_mix_matches_the_reference(S, with_state):
    jcfg, cfg = _cfgs("rwkv6-7b")
    p = jrwkv.rwkv_init(jax.random.PRNGKey(S), jcfg, jnp.float32)
    names, leaves = _leaves(p)
    b, d = 2, jcfg.d_model
    H, D = jcfg.rwkv_heads, jcfg.rwkv_head_dim
    x = _rng_arrays(S, [(b, S, d)])[0]
    st = []
    if with_state:
        st = _rng_arrays(S + 2, [(b, d), (b, d), (b, H, D, D)])
        st[2] *= 0.5

    def port(*a):
        prm = dict(zip(names, a[:len(names)]))
        state = trwkv.RWKVState(*a[len(names) + 1:]) if with_state else None
        out, x_tm, wkv = trwkv.rwkv_time_mix(prm, a[len(names)], cfg,
                                             state=state)
        return (out,) if state is None else (out, wkv)

    def ref(*a):
        prm = dict(zip(names, a[:len(names)]))
        if not with_state:
            return (jrwkv.rwkv_time_mix(prm, a[len(names)], jcfg)[0],)
        state = jrwkv.RWKVState(*a[len(names) + 1:])
        out, _, wkv = _jax_time_mix_real_steps(prm, a[len(names)], jcfg,
                                               state)
        return out, wkv

    ins = leaves + [x] + st
    outs_np = [np.asarray(o) for o in ref(*map(jnp.asarray, ins))]
    cots = _rng_arrays(S + 3, [o.shape for o in outs_np])
    outs, grads = _torch_vjp(port, ins, cots)
    jouts, jgrads = _jax_vjp(ref, ins, cots)
    for o, jo in zip(outs, jouts):
        _close(o, jo)
    # x_cm takes no part in the time mix: no gradient on either side.
    for name, g, jg in zip(names + ["x", "x_tm", "x_cm", "wkv"], grads,
                           jgrads):
        if name == "x_cm":
            assert g is None and not np.asarray(jg).any()
            continue
        _close(g, jg, f"d{name}")


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------

def _tensors(arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("S", [1, 7])
def test_opcheck(S):
    ssm, wkv = _ssm_inputs(S, S), _wkv_inputs(S, S)
    torch.library.opcheck(torch.ops.repro_torch.ssm_scan_fwd,
                          (*_tensors(ssm, True), 4))
    torch.library.opcheck(torch.ops.repro_torch.wkv6_fwd,
                          (*_tensors(wkv, True), 4))
    y, h, carries = sops.ssm_scan_fwd(*_tensors(ssm), 4)
    torch.library.opcheck(torch.ops.repro_torch.ssm_scan_bwd,
                          (torch.randn_like(y), torch.randn_like(h),
                           *_tensors(ssm)[:6], carries, 4))
    y, S_last, carries = sops.wkv6_fwd(*_tensors(wkv), 4)
    torch.library.opcheck(torch.ops.repro_torch.wkv6_bwd,
                          (torch.randn_like(y), torch.randn_like(S_last),
                           *_tensors(wkv)[:5], carries, 4))


class _OpNames(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func._overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "rwkv6-7b"])
@pytest.mark.parametrize("S", [1, 300])
def test_meta_dispatches_one_scan_op_a_layer_and_pass(arch, S):
    jcfg, cfg = _cfgs(arch)
    if arch == "rwkv6-7b":
        p = jrwkv.rwkv_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
        fn, op = (lambda prm, x: trwkv.rwkv_time_mix(prm, x, cfg)[0]), "wkv6"
    else:
        p = jmam.mamba_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
        fn, op = (lambda prm, x: tmam.mamba_forward(prm, x, cfg)[0]), \
            "ssm_scan"
    prm = {n: torch.from_numpy(np.array(a)).to("meta").requires_grad_()
           for n, a in p.items()}
    x = torch.empty((2, S, cfg.d_model), device="meta", requires_grad=True)
    mode = _OpNames()
    with mode:
        out = fn(prm, x)
        out.sum().backward()
    scans = [n for n in mode.names if "repro_torch" in n]
    assert scans == [f"repro_torch.{op}_fwd", f"repro_torch.{op}_bwd"]
    assert x.grad.shape == x.shape and x.grad.device.type == "meta"


def _saved_bytes(fn, inputs):
    """Bytes of the distinct storages autograd saves for backward during
    ``fn(*inputs)``, not counting the inputs' own storages (which the
    caller holds whatever the scan saves)."""
    mine = {t.untyped_storage().data_ptr() for t in inputs}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in mine:
            seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*inputs)
    return sum(seen.values())


SAVED_CASES = {
    "mamba._ssm_scan": (lambda *a: tmam._ssm_scan(*a),
                        lambda S: _ssm_inputs(0, S, bt=1, inner=64, N=16)),
    "ssm_scan_plain": (sref.ssm_scan_plain,
                       lambda S: _ssm_inputs(0, S, bt=1, inner=64, N=16)),
    "ops.wkv6": (sops.wkv6, lambda S: _wkv_inputs(0, S, b=1, H=2, D=16)),
    "wkv6_plain": (sref.wkv6_plain,
                   lambda S: _wkv_inputs(0, S, b=1, H=2, D=16)),
}


@pytest.mark.parametrize("case", sorted(SAVED_CASES))
def test_backward_saves_one_carry_a_chunk(case):
    """ROADMAP C.20: at S = 2048 autograd keeps at most (S / 128 + one
    chunk's 128 steps) states beyond the caller's inputs (the JAX
    package's chunked remat); a scan that saves its states step by step
    keeps about 2.2 a position."""
    fn, make = SAVED_CASES[case]
    S = 2048
    ins = _tensors(make(S), True)
    state = ins[-1][0].numel() * 4 * ins[-1].shape[0]     # one h0 / S0
    saved = _saved_bytes(fn, ins)
    assert saved <= (S // 128 + 128) * state, \
        f"{case} saves {saved / state:.1f} states"


@pytest.mark.parametrize("S", [1, 131])
def test_flop_formulas_equal_the_plain_count(S):
    for plain, op, ins, formula in (
            (sref.ssm_scan_plain, sops.ssm_scan, _ssm_inputs(1, S),
             lambda a: sops.ssm_scan_flops(a[0].shape, a[4].shape)),
            (sref.wkv6_plain, sops.wkv6, _wkv_inputs(1, S),
             lambda a: sops.wkv6_flops(a[0].shape))):
        counts = []
        for fn in (plain, op):
            ts = _tensors(ins, True)
            outs, fwd = analyze(fn, *ts)
            _, bwd = analyze(torch.autograd.backward, outs,
                             [torch.ones_like(o) for o in outs])
            counts.append((fwd.flops, bwd.flops))
        assert counts[0] == counts[1] == (formula(ins), 3 * formula(ins))


def test_chunks_cover_the_real_steps_only():
    assert sref.chunks(1) == [(0, 1)]
    assert sref.chunks(131) == [(0, 128), (128, 131)]
    assert sref.chunks(300, 128) == [(0, 128), (128, 256), (256, 300)]
    assert sref.n_chunks(131) == (128, 2) and sref.n_chunks(5) == (5, 1)


def test_cuda_launches_refuse_unsupported_shapes():
    """The kernels are compiled for N in {8, 16} and D in {16, 64}; the
    launch raises before touching a card for anything else."""
    ssm = _tensors(_ssm_inputs(0, 3, N=4))
    with pytest.raises(ValueError, match="N in"):
        sops.launch_ssm_fwd(*ssm)
    wkv = _tensors(_wkv_inputs(0, 3, D=8))
    with pytest.raises(ValueError, match="D in"):
        sops.launch_wkv6_fwd(*wkv)
    with pytest.raises(ValueError, match="f32"):
        sops.launch_wkv6_fwd(*[t.double() for t in wkv])


@pytest.mark.parametrize("family", ["ssm_scan", "wkv6"])
def test_dry_run_peak_holds_the_backward_workspace(family):
    """On ``meta``, the counter's peak for one backward operator is its
    outputs plus the workspace its kernel allocates
    (``ssm_bwd_workspace`` / ``wkv6_bwd_workspace``, the shapes the
    launch allocates)."""
    from repro_torch.utils.cost_analysis import analyze_with_memory
    if family == "ssm_scan":
        bt, S, inner, N = 2, 300, 128, 16
        ins = [torch.empty(s, device="meta") for s in (
            (bt, S, inner), (bt, S, inner), (bt, S, N), (bt, S, N),
            (inner, N), (inner,), (bt, inner, N))]
        y, h, carries = sops.ssm_scan_fwd(*ins, 128)
        args = (torch.empty_like(y), torch.empty_like(h), *ins[:6], carries)
        op = torch.ops.repro_torch.ssm_scan_bwd
        ws = sops.ssm_bwd_workspace(bt, S, inner, N)
    else:
        b, S, H, D = 2, 300, 4, 64
        ins = [torch.empty(s, device="meta") for s in (
            *[(b, S, H, D)] * 4, (H, D), (b, H, D, D))]
        y, S_last, carries = sops.wkv6_fwd(*ins, 128)
        args = (torch.empty_like(y), torch.empty_like(S_last), *ins[:5],
                carries)
        op = torch.ops.repro_torch.wkv6_bwd
        ws = sops.wkv6_bwd_workspace(b, S, H, D)
    outs, _, mem = analyze_with_memory(op, *args, 128)
    out_bytes = sum(t.numel() * 4 for t in outs)
    ws_bytes = sum(4 * int(np.prod(s)) for s in ws)
    assert ws_bytes > 0 and mem.peak == out_bytes + ws_bytes


def test_wkv6_backward_workspace_is_the_sub_chunk_starts():
    """The WKV backward kernel keeps the states at the starts of one
    chunk's sub-chunks of ``WKV_SUBCHUNK`` steps, but the first (the
    carry) and the last (in registers): at rwkv6-7b's B = 4, S = 512,
    H = D = 64, 56 MiB, at most 128 MiB and a ninth of a whole chunk's
    states; none below three sub-chunks."""
    ws, du_part = sops.wkv6_bwd_workspace(4, 512, 64, 64)
    assert sops.WKV_SUBCHUNK == 8
    assert ws == (4, 64, 128 // 8 - 2, 64, 64) and du_part == (4, 64, 64)
    ws_bytes = 4 * int(np.prod(ws))
    assert ws_bytes == 56 * 2**20 <= 128 * 2**20
    assert 9 * ws_bytes <= 4 * 4 * 64 * 128 * 64 * 64
    assert sops.wkv6_bwd_workspace(2, 20, 3, 16)[0] == (2, 3, 1, 16, 16)
    for S in (1, 7, 16):
        assert sops.wkv6_bwd_workspace(2, S, 3, 16)[0][2] == 0
    assert sops.wkv6_bwd_workspace(2, 4096, 3, 64, chunk=100)[0][2] == 11


@pytest.mark.parametrize("shape", [
    (1, 4096, 16384, 16),      # jamba's layer at 1 x 4096
    (4, 512, 16384, 16),       # [lm]'s prefill at jamba's widths
    (2, 131, 200, 8),          # three full CTAs and a ragged one
    (3, 137, 133, 16),         # inner no multiple of 4
    (1, 1, 5, 8),              # one step, one ragged CTA
])
def test_ssm_backward_workspace_is_the_sub_chunk_layout(shape):
    """The Mamba backward kernel keeps the states it recomputes on the
    chip (each chunk's sub-chunk starts in shared memory), so its global
    workspace is the per-CTA partials of dB and dC (a CTA a
    ``SSM_CHANNELS`` channels) and the per-row partials of dA and dD: at
    jamba's 1 x 4096 at most 150 MiB (129.06 MiB; a whole chunk's states
    took 128 MiB more)."""
    bt, S, inner, N = shape
    nblk = -(-inner // 64)
    ws = sops.ssm_bwd_workspace(bt, S, inner, N)
    assert sops.SSM_CHANNELS == 64
    assert ws == ((nblk, bt, S, N), (nblk, bt, S, N), (bt, inner, N),
                  (bt, inner))
    ws_bytes = sum(4 * int(np.prod(s)) for s in ws)
    if shape[:3] == (1, 4096, 16384):
        assert ws_bytes == (128 + 1) * 2**20 + 4 * 16384
        assert ws_bytes <= 150 * 2**20


def test_ssm_launches_refuse_chunks_past_shared_memory():
    """The Mamba backward kernel's sub-chunk starts live in shared memory,
    so both launches take chunks of at most ``SSM_MAX_CHUNK`` steps and
    raise before touching a card for a longer one: the forward too, so
    that no forward runs whose backward would be refused."""
    ins = _tensors(_ssm_inputs(0, 300, bt=1, inner=8, N=16))
    for chunk, nc in ((300, 1), (sops.SSM_MAX_CHUNK + 1, 2)):
        with pytest.raises(ValueError, match="chunks of at most"):
            sops.launch_ssm_fwd(*ins, chunk=chunk)
        with pytest.raises(ValueError, match="chunks of at most"):
            sops.launch_ssm_bwd(ins[0], ins[-1], *ins[:6],
                                torch.zeros((1, nc, 8, 16)), chunk=chunk)
    assert sops._ssm_chunks(300, sops.SSM_MAX_CHUNK) == (256, 2)
    assert sops._ssm_chunks(200, 300) == (200, 1)
