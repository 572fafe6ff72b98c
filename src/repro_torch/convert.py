"""Carry a fitted model across from the JAX package.

The JAX package's parameters are handed over as numpy arrays and plain
floats (this module imports nothing of it): the spec (nu1, nu2, eps and
the kernel's name, gamma, coef0, degree), the dual coefficients gamma,
the offsets rho1/rho2 and the training rows X. Out come the port's
``SlabSpec``, ``OCSSVMModel`` and ``SMOResult`` on the chosen device, so
a model fitted by one package can be packed and scored by the other.

LM parameters cross the same way (``lm_params_from_numpy``): the JAX
package's ``init_params`` tree as numpy arrays, whose whole pattern
periods are stacked (R, ...) per period position under "segments" and
whose partial period is the list "tail", becomes the port's ``Decoder``,
one module per layer in stack order (``layers_of`` is that re-indexing,
for caches too). A training state crosses with ``train_state_from_numpy``
/ ``train_state_to_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine.types import SMOResult
from repro_torch.core.kernel_fn import KernelFn
from repro_torch.core.ocssvm import OCSSVMModel, SlabSpec
from repro_torch.utils.tree import Stacked, map_tree


def spec_from_params(*, nu1: float, nu2: float, eps: float, kernel: str,
                     gamma: float = 1.0, coef0: float = 0.0,
                     degree: int = 3) -> SlabSpec:
    """A ``SlabSpec`` from host floats; ``kernel`` is the kernel's name."""
    return SlabSpec(nu1=float(nu1), nu2=float(nu2), eps=float(eps),
                    kernel=KernelFn(name=str(kernel), gamma=float(gamma),
                                    coef0=float(coef0), degree=int(degree)))


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def model_from_params(*, gamma, rho1: float, rho2: float, X,
                      spec: SlabSpec, device="cpu") -> OCSSVMModel:
    """An ``OCSSVMModel`` from the dual coefficients (m,), the offsets
    and the training rows (m, d)."""
    gamma = _f32(gamma, device).reshape(-1)
    X = _f32(X, device)
    if X.ndim != 2 or X.shape[0] != gamma.shape[0]:
        raise ValueError(f"gamma {tuple(gamma.shape)} and X "
                         f"{tuple(X.shape)} do not describe one model")
    return OCSSVMModel(gamma=gamma, rho1=_f32(rho1, device),
                       rho2=_f32(rho2, device), X=X, spec=spec)


def result_from_params(*, model: OCSSVMModel, iters: int, n_viol: int,
                       max_viol: float, gap: float, converged: bool,
                       f=None) -> SMOResult:
    """An ``SMOResult`` around a carried-across model and its solve's
    diagnostics (``f`` is the optional final f-cache)."""
    dev = model.gamma.device
    return SMOResult(
        model=model,
        iters=torch.tensor(int(iters), dtype=torch.int32, device=dev),
        n_viol=torch.tensor(int(n_viol), dtype=torch.int32, device=dev),
        max_viol=_f32(max_viol, dev), gap=_f32(gap, dev),
        converged=torch.tensor(bool(converged), device=dev),
        f=None if f is None else _f32(f, dev).reshape(-1))


def layers_of(tree: dict, cfg) -> list:
    """The per-layer subtrees of a JAX-layout tree (parameters or a
    cache), in stack order: layer j is period position j % period of
    whole period j // period, then the tail."""
    out = []
    for j in range(cfg.n_layers):
        r, i = divmod(j, cfg.period)
        if r < cfg.n_repeats:
            out.append(map_tree(lambda a, r=r: a[r],
                                tree["segments"][f"l{i}"]))
        else:
            out.append(tree["tail"][j - cfg.n_repeats * cfg.period])
    return out


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: its 2-byte bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def lm_params_from_numpy(tree: dict, cfg, device=None):
    """The port's ``Decoder`` from the JAX package's ``init_params`` tree
    as numpy arrays, on ``device`` (default: the CUDA card; ``"cpu"`` on
    the CPU); every leaf keeps its dtype."""
    from repro_torch.api import resolve_device
    from repro_torch.models.transformer import Decoder
    dev = resolve_device(device)
    to = lambda a: _tensor(a, dev)                        # noqa: E731
    return Decoder(cfg, {
        "embed": to(tree["embed"]), "final_norm": to(tree["final_norm"]),
        "unembed": to(tree["unembed"]),
        "layers": [map_tree(to, t) for t in layers_of(tree, cfg)]})


def lm_params_to_numpy(params, cfg) -> dict:
    """The inverse of ``lm_params_from_numpy``: the JAX package's tree of
    numpy arrays (bf16 leaves come back as f32: numpy has no bf16)."""
    from repro_torch.models.transformer import param_tree
    return param_tree_to_numpy(param_tree(params))


def param_tree_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The port's ``param_tree`` (``Stacked`` per-layer tensors under
    "segments") from a tree of numpy arrays in the JAX layout: the
    parameters, or anything shaped like them (gradients)."""
    from repro_torch.models.transformer import param_tree
    return param_tree(lm_params_from_numpy(tree, cfg, device=device))


def _stacked_from(a, device):
    """A stacked (R, ...) numpy leaf as a ``Stacked`` of R tensors."""
    t = _tensor(a, device)
    return Stacked(t[r].clone() for r in range(t.shape[0]))


def _jax_layout(fn_stacked, fn_leaf, tree: dict) -> dict:
    """``tree`` (the JAX layout) with ``fn_stacked`` over the leaves under
    "segments" and ``fn_leaf`` over every other leaf."""
    out = {k: map_tree(fn_leaf, v) for k, v in tree.items()
           if k != "segments"}
    if "segments" in tree:
        out["segments"] = map_tree(fn_stacked, tree["segments"])
    return out


def train_state_from_numpy(state, cfg, device=None):
    """The port's ``TrainState`` from the JAX package's, as numpy (any
    named tuples with its fields: ``params``, ``opt_state`` — an
    ``AdamWState`` (step, m, v) or ``AdafactorState`` (step, vr, vc) —
    and ``step``). Parameters and AdamW's moments become ``Stacked``
    per-layer tensors under "segments"; Adafactor's ``vr`` / ``vc`` stay
    whole (R, ...) tensors there, as the state of one stacked leaf
    (ROADMAP C.16)."""
    from repro_torch.api import resolve_device
    from repro_torch.optim import adafactor, adamw
    from repro_torch.train.train_step import TrainState
    dev = resolve_device(device)
    params = param_tree_from_numpy(state.params, cfg, device=dev)
    to = lambda a: _tensor(a, dev)                        # noqa: E731
    stacked = lambda a: _stacked_from(a, dev)             # noqa: E731
    opt = state.opt_state
    step = lambda s: torch.tensor(int(np.asarray(s)),     # noqa: E731
                                  dtype=torch.int32, device=dev)
    if hasattr(opt, "vr"):
        opt_state = adafactor.AdafactorState(
            step=step(opt.step), vr=_jax_layout(to, to, opt.vr),
            vc=_jax_layout(to, to, opt.vc))
    else:
        opt_state = adamw.AdamWState(
            step=step(opt.step), m=_jax_layout(stacked, to, opt.m),
            v=_jax_layout(stacked, to, opt.v))
    return TrainState(params=params, opt_state=opt_state,
                      step=step(state.step))


def param_tree_to_numpy(tree) -> dict:
    """The inverse of ``param_tree_from_numpy``: a tree of tensors in the
    JAX layout (a ``param_tree``, its gradients, an optimizer's moments)
    as numpy, each ``Stacked`` stacked again (bf16 leaves come back as
    f32: numpy has no bf16)."""
    def leaf(t):
        if isinstance(t, Stacked):
            t = t.stack()
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return map_tree(leaf, tree, stacked=True)


def train_state_to_numpy(state, cfg):
    """The inverse of ``train_state_from_numpy``: the port's
    ``TrainState``, ``AdamWState`` / ``AdafactorState`` named tuples over
    numpy trees in the JAX layout (``param_tree_to_numpy``)."""
    opt = state.opt_state
    return type(state)(
        params=param_tree_to_numpy(state.params),
        opt_state=type(opt)(*(param_tree_to_numpy(getattr(opt, f))
                              for f in opt._fields)),
        step=param_tree_to_numpy(state.step))
