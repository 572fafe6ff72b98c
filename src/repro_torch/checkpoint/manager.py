"""Atomic, hash-verified checkpoints in plain npz + JSON manifest.

Layout:  <dir>/step_000123/
            manifest.json   {step, tree structure, keys, sha256, extra}
            arrays.npz      flat leaf arrays keyed by tree path

Writes go to a tmp dir + atomic rename, so a crash mid-save never corrupts
the latest checkpoint (fault-tolerance invariant). ``AsyncCheckpointer``
moves serialization off the caller's thread. Any tree of dicts, lists,
tuples, named tuples and tensors works — solver state, data cursors and
fitted results alike.

The on-disk format is the JAX package's, so a checkpoint crosses
packages:

* leaves are visited in the order ``jax.tree_util`` visits them (dict keys
  sorted, named tuples by field, ``None`` holding no leaf) and keyed by
  their path ("res/model/gamma"); a ``SlabSpec`` has one child, its kernel
  ("0"), and a ``KernelFn`` two, gamma ("0") and coef0 ("1"), as the JAX
  package registers them. The same tree gives the same keys, and
  ``arrays.npz`` byte for byte the JAX package's file (the zip entries
  carry the time of writing, as ``np.savez`` stamps them);
* a ``utils.tree.Stacked`` (the per-layer tensors of one JAX leaf) is
  written as the stacked (R, ...) array the JAX tree holds, and read back
  into per-layer tensors, so a ``TrainState``'s checkpoint is the JAX
  package's;
* a bf16 leaf is written as its 2-byte bits under the descriptor "<V2",
  as numpy writes ml_dtypes' bfloat16, and read back into
  ``torch.bfloat16`` through an int16 view. (The JAX package writes its
  bf16 leaves so but cannot restore them: ROADMAP C.11.)

Only the manifest's ``treedef`` string differs from the JAX package's.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import io
import json
import os
import shutil
import threading
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.kernel_fn import KernelFn
from repro_torch.core.ocssvm import SlabSpec
from repro_torch.sharding.collectives import shard
from repro_torch.sharding.specs import NamedSharding
from repro_torch.utils.tree import Stacked

# numpy's descriptor of ml_dtypes' bfloat16: a 2-byte void, little-endian.
_BF16_DESCR = "<V2"
_V2 = np.dtype("V2")


class _Leaf:
    def __repr__(self) -> str:
        return "*"


def _map(fn: Callable, tree, path: tuple = ()):
    """``tree`` rebuilt with ``fn(path, leaf)`` in place of each leaf, the
    leaves visited in the JAX package's order; ``path`` is a tuple of
    str. Dicts keep their own key order."""
    if tree is None:
        return None
    if isinstance(tree, Stacked):
        return fn(path, tree)
    if isinstance(tree, SlabSpec):
        return dataclasses.replace(
            tree, kernel=_map(fn, tree.kernel, path + ("0",)))
    if isinstance(tree, KernelFn):
        return dataclasses.replace(tree, gamma=fn(path + ("0",), tree.gamma),
                                   coef0=fn(path + ("1",), tree.coef0))
    if isinstance(tree, dict):
        ordered = isinstance(tree, collections.OrderedDict)
        out = {k: _map(fn, tree[k], path + (str(k),))
               for k in (tree if ordered else sorted(tree))}
        rebuilt = {k: out[k] for k in tree}
        return collections.OrderedDict(rebuilt) if ordered else rebuilt
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x, path + (str(i),))
                          for i, x in enumerate(tree))
    return fn(path, tree)


def _path_key(path) -> str:
    return "/".join(path)


def _host(leaf, *, copy: bool) -> np.ndarray:
    """One leaf as a host array, bf16 as its bits (a 2-byte void array).
    ``copy``: never share memory with the leaf (a CUDA tensor's transfer
    is a copy already)."""
    if isinstance(leaf, Stacked):
        leaf = torch.stack([t.detach() for t in leaf])
        copy = False
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        elif copy:
            t = t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_V2)
        return t.numpy()
    return np.array(leaf) if copy else np.asarray(leaf)


def _flatten_with_paths(tree) -> dict:
    flat = {}

    def take(path, leaf):
        flat[_path_key(path)] = _host(leaf, copy=False)
        return leaf
    _map(take, tree)
    return flat


def _treedef(tree) -> str:
    return f"PyTreeDef({_map(lambda path, leaf: _Leaf(), tree)!r})"


def _savez(path: str, flat: dict) -> None:
    """``np.savez(path, **flat)``, but a bf16 leaf's bits go under
    ``_BF16_DESCR`` (numpy would write a bare void's "|V2")."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fp:
                if arr.dtype == _V2:
                    np.lib.format.write_array_header_1_0(fp, {
                        "descr": _BF16_DESCR, "fortran_order": False,
                        "shape": arr.shape})
                    fp.write(np.ascontiguousarray(arr).tobytes())
                else:
                    np.lib.format.write_array(fp, arr, allow_pickle=False)


def save(directory: str, step: int, tree: Any, *,
         extra: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = _flatten_with_paths(tree)
    npz_path = os.path.join(tmp, "arrays.npz")
    _savez(npz_path, flat)
    with open(npz_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()

    manifest = {
        "step": step,
        "treedef": _treedef(tree),
        "keys": sorted(flat),
        "sha256": digest,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _leaf_from(arr: np.ndarray, like, device):
    """A stored array in the form of the ``like`` leaf: a tensor with its
    dtype, on ``device`` (default: its device) or laid out by a
    ``NamedSharding`` (this rank's shard); a ``Stacked`` of per-layer
    tensors (``device`` then a ``Stacked`` too, or None); a numpy array
    with its dtype; a number of its type (host floats, as
    ``concrete_spec`` wants)."""
    if isinstance(like, Stacked):
        return Stacked(_leaf_from(arr[r], like[r], None if device is None
                                  else device[r])
                       for r in range(len(like)))
    if isinstance(device, NamedSharding):
        full = _leaf_from(arr, like, None)
        return shard(full, device.spec, device.mesh)
    t = None
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:    # bf16 bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr.copy()) if t is None else t
        return t.to(device=like.device if device is None else device,
                    dtype=like.dtype)
    if t is not None:
        arr = t.float().numpy()
    if device is not None:
        return torch.as_tensor(arr, device=device)
    if isinstance(like, np.ndarray):
        return np.asarray(arr, dtype=like.dtype)
    if isinstance(like, (np.generic, bool, int, float, complex)):
        return type(like)(arr)
    return arr


def restore(directory: str, step: int, like: Any, *,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``like`` (each leaf's dtype and
    device kept).

    ``shardings``: optional matching tree of ``torch.device`` (a ``None``
    keeps the ``like`` leaf's device; a leaf that is no tensor comes back
    as one on its device) — the same checkpoint restored onto other
    devices — or of ``sharding.specs.NamedSharding`` (each leaf comes
    back as this rank's shard of the stored full array, on the ``like``
    leaf's device: ``checkpoint.reshard``); a ``Stacked`` leaf takes a
    ``Stacked`` of them.
    """
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "arrays.npz"), "rb") as f:
        blob = f.read()
    if hashlib.sha256(blob).hexdigest() != manifest["sha256"]:
        raise IOError(f"checkpoint {path} corrupt: sha mismatch")
    placement = {}
    if shardings is not None:
        _map(lambda p, dev: placement.setdefault(_path_key(p), dev),
             shardings)
    with np.load(io.BytesIO(blob)) as data:
        return _map(lambda p, leaf: _leaf_from(
            data[_path_key(p)], leaf, placement.get(_path_key(p))), like)


def restore_latest(directory: str, like: Any, *, shardings: Any = None):
    step = latest_step(directory)
    if step is None:
        return None, None
    return restore(directory, step, like, shardings=shardings), step


class AsyncCheckpointer:
    """Serialize + write off the caller's thread; at most one in flight."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._inflight: Optional[Future] = None
        self._lock = threading.Lock()

    def save(self, step: int, tree: Any, *,
             extra: Optional[dict] = None) -> Future:
        # Block on the previous write (bounded staleness), then copy every
        # leaf to host memory synchronously so the caller may mutate
        # afterwards (a CPU tensor or numpy leaf would otherwise be shared
        # with the write).
        self.wait()
        host_tree = _map(lambda path, leaf: _host(leaf, copy=True), tree)

        def work():
            p = save(self.directory, step, host_tree, extra=extra)
            self._gc()
            return p

        with self._lock:
            self._inflight = self._pool.submit(work)
        return self._inflight

    def wait(self):
        with self._lock:
            f = self._inflight
        if f is not None:
            f.result()

    def _gc(self):
        steps = sorted(s for s in (
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
