"""The port's sharding rules (``repro_torch.sharding.specs``,
``repro_torch.launch.specs``) held against the JAX package's, and the
pure pieces of the sharded path, in one process on the CPU.

* ``make_param_specs`` equals the JAX package's for all ten archs at
  their PUBLISHED shapes (the JAX side from ``eval_shape`` on a
  ``jax.sharding.AbstractMesh``, the port's from meta tensors), on the
  meshes (1, 1), (2, 2), (16, 16) and (2, 16, 16), fsdp on and off,
  layouts "tp" and "fsdp", moe_layout "psum" and "a2a". A stacked JAX
  leaf's spec is the port's per-layer spec with a leading ``None``.
* ``opt_state_shardings`` (AdamW's m / v, Adafactor's vr / vc, the fsdp
  layout's ZeRO-2 "densify") and ``train_state_shardings`` equal the JAX
  package's on the same cells; ``batch_sds_and_shardings`` too, for
  batches of 1, 2, 8, 256 and 512.
* ``cache_spec_for_leaf`` equals the JAX package's on every leaf of
  each arch's cache (batch 1, 2 and 256, the JAX cache's own paths);
  ``make_cache_shardings`` lays the port's own cache leaf by leaf.
* ``compress`` is bitwise the JAX package's (q, scale and residual).
* ``shard`` / ``unshard`` round-trip bitwise on a one-rank mesh, and
  ``shard`` cuts the blocks ``jax.device_put`` would give each device.

Specs compare with the JAX package's normalised: a one-name tuple is the
name, trailing ``None`` entries dropped.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as JARCHS
from repro.launch import specs as jspecs
from repro.optim import compression as jcomp
from repro.sharding import specs as jsh
from repro_torch.configs import ARCHS
from repro_torch.launch import specs as tspecs
from repro_torch.optim import compression as tcomp
from repro_torch.sharding import specs as tsh
from repro_torch.sharding.collectives import shard, unshard
from repro_torch.utils.tree import Stacked

ARCH_IDS = sorted(JARCHS)
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(m, fsdp, layout) for m in MESHES for fsdp in (True, False)
         for layout in ("tp", "fsdp")]


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
    """{path: normalised spec} of a JAX tree of specs or shardings."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JP, jax.sharding.Sharding)))[0]
    return {_key(p): _norm(getattr(v, "spec", v)) for p, v in leaves}


def _port_flat(tree, path=()) -> dict:
    """The same of a port tree of specs / NamedShardings: a ``Stacked``
    of per-layer specs is the stacked leaf's (a leading None)."""
    if isinstance(tree, Stacked):
        spec = getattr(tree[0], "spec", tree[0])
        return {"/".join(path): _norm((None,) + tuple(spec))}
    if isinstance(tree, (tsh.PartitionSpec, tsh.NamedSharding)):
        return {"/".join(path): _norm(getattr(tree, "spec", tree))}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_flat(tree[k], path + (str(k),)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_port_flat(getattr(tree, f), path + (f,)))
        return out
    out = {}
    for i, t in enumerate(tree):
        out.update(_port_flat(t, path + (str(i),)))
    return out


def _meshes(name):
    sizes, axes = MESHES[name]
    return JAbstractMesh(sizes, axes), tsh.AbstractMesh(sizes, axes)


@pytest.fixture(autouse=True, scope="module")
def _jax_shapes_once():
    """The JAX package's ``params_sds`` traces ``init_params`` on every
    call; its spec functions call it several times a cell. One trace an
    arch (the shapes do not change)."""
    real = jspecs.params_sds
    jspecs.params_sds = functools.lru_cache(maxsize=None)(real)
    yield
    jspecs.params_sds = real


def _jax_params(arch):
    return jspecs.params_sds(JARCHS[arch])


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return tspecs.params_sds(ARCHS[arch])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax_at_published_shapes(arch):
    jp, tp = _jax_params(arch), _port_params(arch)
    n = 0
    for (mesh, fsdp, layout), moe in itertools.product(CELLS,
                                                       ("psum", "a2a")):
        jm, tm = _meshes(mesh)
        want = _jax_flat(jsh.make_param_specs(jp, jm, fsdp=fsdp,
                                              layout=layout, moe_layout=moe))
        got = _port_flat(tsh.make_param_specs(tp, tm, fsdp=fsdp,
                                              layout=layout, moe_layout=moe))
        assert got == want, (mesh, fsdp, layout, moe)
        n += len(want)
    assert n > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_state_shardings_match_jax(arch):
    jcfg, cfg = JARCHS[arch], ARCHS[arch]
    for mesh, fsdp, layout in CELLS:
        jm, tm = _meshes(mesh)
        want = jspecs.train_state_shardings(jcfg, jm, fsdp=fsdp,
                                            layout=layout)
        got = tspecs.train_state_shardings(cfg, tm, fsdp=fsdp, layout=layout)
        assert _port_flat(got.params) == _jax_flat(want.params)
        # the optimizer state in the JAX layout (stacked leaves whole)
        assert _port_flat(got.opt_state) == _jax_flat(want.opt_state), \
            (mesh, fsdp, layout)
        assert _norm(got.step.spec) == _norm(want.step.spec) == ()
        for batch in (1, 2, 8, 256, 512):
            jsds, jshd = jspecs.batch_sds_and_shardings(
                jcfg, jm, batch, 512, layout=layout)
            tsds, tshd = tspecs.batch_sds_and_shardings(
                cfg, tm, batch, 512, layout=layout)
            assert sorted(jshd) == sorted(tshd)
            for k in jshd:
                assert _norm(tshd[k].spec) == _norm(jshd[k].spec)
                assert tuple(tsds[k].shape) == tuple(jsds[k].shape)
                assert tsds[k].device.type == "meta"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_jax(arch):
    jcfg = JARCHS[arch]
    for (mesh, _, _), batch in itertools.product(CELLS[::4], (1, 2, 256)):
        jm, tm = _meshes(mesh)
        cache = jspecs.cache_sds(jcfg, batch, 4096)
        flat = jax.tree_util.tree_flatten_with_path(cache)[0]
        for path, leaf in flat:
            names = [_key((k,)) for k in path]
            want = _norm(jsh.cache_spec_for_leaf(path, leaf.shape, jm))
            got = _norm(tsh.cache_spec_for_leaf(names, leaf.shape, tm))
            assert got == want, (mesh, batch, names)
    # the port's own cache (one state a layer) through make_cache_shardings
    from repro_torch.models.transformer import init_cache
    _, tm = _meshes("16x16")
    cache = init_cache(ARCHS[arch], 32, 64, device="meta")
    shd = tsh.make_cache_shardings(cache, tm)
    assert shd["pos"].spec == tsh.P()
    for st, sd in zip(cache["layers"], shd["layers"]):
        for f in st._fields:
            spec = getattr(sd, f)
            assert spec.mesh is tm and spec.spec == tsh.cache_spec_for_leaf(
                [f], getattr(st, f).shape, tm)


def test_compress_is_bitwise_the_reference():
    rng = np.random.default_rng(0)
    for i in range(8):
        g = (rng.standard_normal((13, 9)) * 10.0 ** (i - 4)).astype(
            np.float32)
        e = (rng.standard_normal((13, 9)) * 1e-3).astype(np.float32)
        want = [np.asarray(x) for x in jcomp.compress(jnp.asarray(g),
                                                      jnp.asarray(e))]
        got = [x.numpy() for x in tcomp.compress(torch.as_tensor(g),
                                                 torch.as_tensor(e))]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    err = tcomp.init_error_state({"w": torch.ones(3, 2)})
    assert err["w"].dtype == torch.float32 and not err["w"].any()


def test_shard_unshard_round_trip_and_blocks():
    from repro_torch.launch import make_test_mesh
    mesh = make_test_mesh((1, 1), ("data", "model"))
    x = torch.randn(8, 6, generator=torch.Generator().manual_seed(0))
    for spec in (tsh.P(), tsh.P("data", "model"), tsh.P(None, "model"),
                 tsh.P(("data", "model"), None)):
        local = shard(x, spec, mesh)
        assert local.data_ptr() != x.data_ptr()
        assert torch.equal(unshard(local, spec, mesh), x)

    class Rank:
        """A rank's place on a (2, 2) mesh, without processes."""

        def __init__(self, d, m):
            self.shape = {"data": 2, "model": 2}
            self.c = {"data": d, "model": m}

        def axis_rank(self, axes):
            r = 0
            for ax in axes:
                r = r * self.shape[ax] + self.c[ax]
            return r

    full = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    for spec in (("data", "model"), (("data", "model"), None),
                 (None, "data")):
        for d, m in itertools.product(range(2), range(2)):
            got = shard(torch.as_tensor(full), tsh.P(*spec), Rank(d, m))
            # jax's block for the device at (d, m): the same slices
            idx = []
            for dim, e in enumerate(spec):
                axes = () if e is None else ((e,) if isinstance(e, str)
                                             else e)
                n = int(np.prod([2 for _ in axes])) if axes else 1
                size = full.shape[dim] // n
                k = Rank(d, m).axis_rank(axes) if axes else 0
                idx.append(slice(k * size, (k + 1) * size))
            assert np.array_equal(got.numpy(), full[tuple(idx)])
