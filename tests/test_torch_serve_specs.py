"""The serving slice's specs and its per-rank parameter draw, held
against the JAX package (``repro_torch.launch.specs``,
``models.transformer.init_params_sharded``, ``cache_tree``).

* ``cache_sds``, ``decode_specs``, ``opt_state_sds``, ``train_state_sds``
  and ``input_specs`` equal the JAX package's for all ten archs at their
  PUBLISHED shapes, every ``SHAPES`` cell, on the (16, 16) and
  (2, 16, 16) production meshes ("tp" with and without fsdp, "fsdp"):
  each leaf's shape, dtype and ``PartitionSpec`` (the JAX side on a
  ``jax.sharding.AbstractMesh``, which builds its ``NamedSharding`` on no
  devices; the port's from meta tensors). A stacked JAX leaf is the
  port's ``Stacked`` of per-layer leaves: its shape (R, ...), its spec
  the per-layer one with a leading ``None``.
* ``init_params_sharded`` is bitwise ``shard_params(init_params(...))``
  of the same seed on every rank of four gloo ranks on a (2, 2) mesh, for
  the ten reduced archs under "tp" with and without fsdp and under
  "fsdp" (values, dtypes and shapes, leaf for leaf).
* ``cache_tree`` is the JAX ``init_cache``'s layout: a filled cache
  written through the port's checkpoint manager is read by the JAX
  package's ``restore`` bitwise, and the port's own ``restore`` of it
  gives the cache's layers back (``layer_params``).
"""
import functools
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.checkpoint import manager as jmanager
from repro.configs import ARCHS as JARCHS
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro.models.transformer import init_cache as jinit_cache
import torch_dist_ranks as R
from repro_torch.checkpoint import manager
from repro_torch.configs import ARCHS
from repro_torch.configs.base import SHAPES
from repro_torch.launch import specs as tspecs
from repro_torch.models import transformer as tt
from repro_torch.sharding import specs as tsh
from repro_torch.train.serve_step import make_prefill
from repro_torch.utils.tree import Stacked

ARCH_IDS = sorted(JARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = [dict(fsdp=True, layout="tp"), dict(fsdp=False, layout="tp"),
            dict(fsdp=False, layout="fsdp")]
DRAW_CASES = [dict(key=f"{a} {v['layout']}{' fsdp' * v['fsdp']}", arch=a,
                   mesh=[(2, 2), ("data", "model")], **v)
              for a in ARCH_IDS for v in VARIANTS]
RANKS, RANKS_TIMEOUT_S = 4, 400


def _norm(spec) -> tuple:
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, (tuple, list)) else e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _key(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return "/".join(parts)


def _jax_flat(tree) -> dict:
    """{path: (shape, dtype name) or normalised spec} of a JAX tree of
    ShapeDtypeStructs, specs or shardings."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JP, jax.sharding.Sharding)))[0]
    out = {}
    for p, v in leaves:
        if hasattr(v, "dtype"):
            out[_key(p)] = (tuple(v.shape), np.dtype(v.dtype).name)
        else:
            out[_key(p)] = _norm(getattr(v, "spec", v))
    return out


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _port_flat(tree, path=()) -> dict:
    """The same of a port tree: a ``Stacked`` is the stacked leaf (its
    (R, ...) shape; its per-layer spec with a leading None)."""
    key = "/".join(path)
    if isinstance(tree, Stacked):
        first = tree[0]
        if isinstance(first, torch.Tensor):
            return {key: (tuple(tree.shape), _dtype(first))}
        return {key: _norm((None,) + tuple(getattr(first, "spec", first)))}
    if isinstance(tree, torch.Tensor):
        return {key: (tuple(tree.shape), _dtype(tree))}
    if isinstance(tree, (tsh.PartitionSpec, tsh.NamedSharding)):
        return {key: _norm(getattr(tree, "spec", tree))}
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_port_flat(tree[k], path + (str(k),)))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            out.update(_port_flat(getattr(tree, f), path + (f,)))
    else:
        for i, t in enumerate(tree):
            out.update(_port_flat(t, path + (str(i),)))
    return out


@pytest.fixture(autouse=True, scope="module")
def _jax_shapes_once():
    """One trace an arch (and cache shape) of the JAX package's
    ``eval_shape`` stand-ins: its spec functions call them many times."""
    saved = {n: getattr(jspecs, n) for n in
             ("params_sds", "cache_sds", "opt_state_sds")}
    for n, fn in saved.items():
        setattr(jspecs, n, functools.lru_cache(maxsize=None)(fn))
    yield
    for n, fn in saved.items():
        setattr(jspecs, n, fn)


def test_the_shape_cells_are_the_reference_s():
    assert SHAPES == JSHAPES


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch):
    jcfg, cfg = JARCHS[arch], ARCHS[arch]
    n = 0
    for (mesh, (sizes, axes)), shape, kw in itertools.product(
            MESHES.items(), SHAPES, VARIANTS):
        jm, tm = JAbstractMesh(sizes, axes), tsh.AbstractMesh(sizes, axes)
        jkind, jargs, jshd = jspecs.input_specs(jcfg, shape, jm, **kw)
        kind, args, shd = tspecs.input_specs(cfg, shape, tm, **kw)
        assert kind == jkind
        for a, b in ((args, jargs), (shd, jshd)):
            got, want = _port_flat(list(a)), _jax_flat(list(b))
            assert got == want, (mesh, shape, kw)
            n += len(want)
    assert n > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_opt_and_train_state_sds_match_jax(arch):
    jcfg, cfg = JARCHS[arch], ARCHS[arch]
    assert _port_flat(tspecs.opt_state_sds(cfg)) == _jax_flat(
        jspecs.opt_state_sds(jcfg))
    assert _port_flat(tspecs.train_state_sds(cfg)) == _jax_flat(
        jspecs.train_state_sds(jcfg))
    for batch, seq in ((1, 4096), (2, 24), (128, 32768)):
        assert _port_flat(tspecs.cache_sds(cfg, batch, seq)) == _jax_flat(
            jspecs.cache_sds(jcfg, batch, seq))
        for sizes, axes in MESHES.values():
            jm, tm = JAbstractMesh(sizes, axes), tsh.AbstractMesh(sizes, axes)
            got = tspecs.decode_specs(cfg, tm, batch, seq)
            want = jspecs.decode_specs(jcfg, jm, batch, seq)
            assert _port_flat(list(got)) == _jax_flat(list(want)), \
                (batch, seq, sizes)


@pytest.fixture(scope="module")
def draws(tmp_path_factory):
    from repro_torch.launch import spawn_ranks
    return spawn_ranks(R.draw_parity, RANKS,
                       args=(dict(seed=0, cases=DRAW_CASES),),
                       timeout_s=RANKS_TIMEOUT_S,
                       dir=str(tmp_path_factory.mktemp("draws")))


@pytest.mark.parametrize("case", DRAW_CASES,
                         ids=[c["key"] for c in DRAW_CASES])
def test_the_per_rank_draw_is_the_sharded_full_draw(draws, case):
    for r, got in enumerate(draws):
        same, n_leaves, numel = got[case["key"]]
        assert same, f"rank {r}"
        assert n_leaves > 0
    # the ranks hold the model between them, no less
    full = sum(p.numel() for p in tt.init_params(
        R.lm_dist_cfg(case), device="meta").parameters())
    assert sum(g[case["key"]][2] for g in draws) >= full


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "rwkv6-7b",
                                  "gemma3-27b"])
def test_a_cache_checkpoint_is_the_reference_s(tmp_path, arch):
    """A filled cache in ``cache_tree``'s layout through the port's
    manager, read back by the JAX package's ``restore`` (its own
    ``init_cache`` as the template) bitwise, and by the port's."""
    cfg = ARCHS[arch].reduced()
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    cache = tt.init_cache(cfg, 2, 16, device="cpu")
    _, cache = make_prefill(cfg)(params, cache, {"tokens": toks})
    tree = tt.cache_tree(cache, cfg)
    manager.save(str(tmp_path), 3, tree)
    like = jinit_cache(JARCHS[arch].reduced(), 2, 16)
    back = jmanager.restore(str(tmp_path), 3, like)
    got = {_key(p): np.asarray(v) for p, v in
           jax.tree_util.tree_flatten_with_path(back)[0]}
    want = {}

    def walk(t, path):
        if isinstance(t, Stacked):
            want["/".join(path)] = t.stack().numpy()
        elif isinstance(t, torch.Tensor):
            want["/".join(path)] = t.numpy()
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f), path + (f,))
        else:
            for i, x in enumerate(t):
                walk(x, path + (str(i),))
    walk(tree, ())
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == \
            want[k].tobytes(), k
    assert int(got["pos"]) == 12
    mine = manager.restore(str(tmp_path), 3, tree)
    assert int(mine["pos"]) == cache["pos"]
    for a, b in zip(tt.layer_params(mine, cfg), cache["layers"]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
