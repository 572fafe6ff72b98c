"""Cross-process model registry: one warm fleet, N attached workers.

A ``ServingModel`` is immutable once packed — exactly the shape POSIX
shared memory serves well. ``publish`` lays the packed kernel operands
(``t_pad``/``gamma_pad``/``t_norms``) and the compacted reference model
(SV rows, dual coefficients, slab offsets) into ONE
``multiprocessing.shared_memory`` segment, keyed by the caller's string
key (``model_cache.recipe_key`` in the registry flow); ``attach``
rebuilds a ``ServingModel`` from the segment without refitting — the
reconstructed tensors are byte-for-byte the published ones, so an
attached worker's scores are **bitwise identical** to the publisher's
(same bytes into the same ``decision`` launch).

The layout is the JAX package's (``repro.serve.shm_registry``): the same
spool directory, digest, segment name, manifest and array order, so a
segment that either package publishes attaches in the other with the
same bytes. numpy has no bfloat16, so bf16 rows travel as their uint16
bits under the manifest dtype name "bfloat16" (the bytes the JAX
package writes for its bfloat16 arrays); f16 is numpy's "float16".

Beside the segment live two small files in a spool directory
(``$REPRO_SHM_DIR`` or ``<tmp>/repro_shm``), both named by the key's
digest:

* ``<digest>.json``  — the manifest: segment name, per-array
  offset/shape/dtype, and the model metadata (spec, precision, tn, ...);
* ``<digest>.refs``  — the refcount: one pid entry per open lease.

Every mutation of the pair runs under an ``flock`` on ``<digest>.lock``
— advisory file locks are the one primitive that is correct across
unrelated processes and evaporates with its holder. Refcounts are
**liveness-pruned**: every attach/detach drops entries whose pid no
longer exists, so a leader (or any worker) that died without detaching
cannot strand the segment's count — the last LIVE detacher unlinks the
segment and both files. Segments are unregistered from Python's
``resource_tracker`` precisely so they may outlive the process that
created them; the refcount file is what stands in for the tracker.

``attach_or_publish`` is the worker entry point: attach if the fleet is
warm, else build (fit) under a cross-process build lock — so N workers
racing on a cold key pay ONE fit, and the other N-1 block briefly and
attach. POSIX only (flock, pid liveness probes); Windows is out of
scope for this serving stack.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.kernel_fn import KernelFn
from repro_torch.core.ocssvm import OCSSVMModel, SlabSpec
from repro_torch.serve.model_cache import ServingModel

_FORMAT = 1
_ALIGN = 64     # array offsets aligned for clean typed views


class ShmKeyError(KeyError):
    """No published fleet entry for the key (or only a stale manifest
    whose segment is gone — cleaned up on the way out)."""


# -- spool-dir plumbing -------------------------------------------------------
def _spool_dir(dir: Optional[str]) -> Path:
    d = Path(dir or os.environ.get("REPRO_SHM_DIR")
             or Path(tempfile.gettempdir()) / "repro_shm")
    d.mkdir(parents=True, exist_ok=True)
    return d


def _digest(key: str) -> str:
    return hashlib.sha256(key.encode()).hexdigest()[:24]


@contextmanager
def _flock(path: Path):
    import fcntl
    while True:
        f = open(path, "a+")
        try:
            fcntl.flock(f, fcntl.LOCK_EX)
            # The previous holder may have unlinked the lock file after
            # releasing it (last-lease cleanup): a lock held on that
            # dead inode excludes nobody who opens the path fresh.
            # Proceed only if the locked fd still IS the path; retry on
            # the new inode otherwise.
            try:
                st = os.stat(path)
            except FileNotFoundError:
                continue
            fst = os.fstat(f.fileno())
            if (st.st_dev, st.st_ino) != (fst.st_dev, fst.st_ino):
                continue
            yield
            return
        finally:
            try:
                fcntl.flock(f, fcntl.LOCK_UN)
            except OSError:
                pass
            f.close()


def _atomic_write(path: Path, text: str) -> None:
    tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
    tmp.write_text(text)
    os.replace(tmp, path)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True     # exists, just not ours
    return True


def _read_refs(path: Path) -> list:
    try:
        return [int(p) for p in json.loads(path.read_text())["pids"]]
    except (FileNotFoundError, ValueError, KeyError, TypeError):
        return []


def _tracker_name(shm) -> str:
    return getattr(shm, "_name", "/" + shm.name)


def _untrack(shm) -> None:
    # The resource_tracker unlinks registered segments when the
    # REGISTERING process exits — correct for scratch, fatal for a fleet
    # meant to outlive its publisher. The refcount file replaces it.
    # On POSIX CPython 3.8-3.12 ``SharedMemory.__init__`` registers
    # unconditionally — for ATTACH too, not just create (3.13 added
    # ``track=False``) — so EVERY open path must untrack, or any
    # attached worker's tracker unlinks the segment out from under the
    # surviving leaseholders when that worker's process tree exits.
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(_tracker_name(shm), "shared_memory")
    except Exception:
        pass


def _unlink_segment(shm) -> None:
    # ``SharedMemory.unlink()`` also sends an UNREGISTER to the tracker
    # daemon; every segment here was untracked at open, so the
    # unmatched message would make the daemon print KeyError
    # tracebacks. Re-register just before unlinking so the pair
    # balances (on 3.13+ ``track=False`` handles would skip both).
    if getattr(shm, "_track", True):
        try:
            from multiprocessing import resource_tracker
            resource_tracker.register(_tracker_name(shm), "shared_memory")
        except Exception:
            pass
    try:
        shm.unlink()
    except FileNotFoundError:
        _untrack(shm)   # nothing was unlinked: take the registration back
        raise


# -- leases -------------------------------------------------------------------
@dataclasses.dataclass
class ShmLease:
    """One process's handle on a published fleet entry.

    Holding a lease is what keeps the segment alive: ``close()`` (or the
    context manager) drops this pid's refcount entry and — if no live
    holder remains — unlinks the segment and its manifest/refcount
    files. Safe to close twice.
    """

    key: str
    digest: str
    spool: Path
    _shm: object = dataclasses.field(repr=False)
    closed: bool = False

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        man = self.spool / f"{self.digest}.json"
        refs = self.spool / f"{self.digest}.refs"
        with _flock(self.spool / f"{self.digest}.lock"):
            pids = _read_refs(refs)
            me = os.getpid()
            if me in pids:
                pids.remove(me)     # ONE occurrence: leases count
            pids = [p for p in pids if _pid_alive(p)]
            if pids:
                _atomic_write(refs, json.dumps({"pids": pids}))
                self._shm.close()
                return
            # last live holder out turns off the lights
            try:
                _unlink_segment(self._shm)
            except FileNotFoundError:
                pass
            self._shm.close()
            refs.unlink(missing_ok=True)
            man.unlink(missing_ok=True)
            # The lock file goes INSIDE the lock: retiring the inode
            # while holding it is what makes _flock's revalidation
            # sound — a contender that flocked the dying inode sees the
            # path changed under it and retries on the fresh file, so
            # no two holders ever pass revalidation concurrently.
            (self.spool / f"{self.digest}.lock").unlink(missing_ok=True)

    def __enter__(self) -> "ShmLease":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):      # best effort; explicit close is the API
        try:
            self.close()
        except Exception:
            pass


# -- pack / unpack ------------------------------------------------------------
def _host(t: torch.Tensor, dtype: Optional[torch.dtype] = None
          ) -> Tuple[np.ndarray, str]:
    """(host bytes as numpy, manifest dtype name) of one tensor; bf16 as
    its uint16 bits named "bfloat16"."""
    t = t.detach()
    if dtype is not None:
        t = t.to(dtype)
    t = t.cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _host_arrays(sm: ServingModel) -> Dict[str, Tuple[np.ndarray, str]]:
    """The byte-carrying views of a packed model, in manifest order."""
    f32 = torch.float32
    rho = torch.stack([torch.as_tensor(sm.model.rho1).to(f32).cpu(),
                       torch.as_tensor(sm.model.rho2).to(f32).cpu()])
    return {
        "t_pad": _host(sm.t_pad),
        "gamma_pad": _host(sm.gamma_pad, f32),
        "t_norms": _host(sm.t_norms, f32),
        "sv_gamma": _host(sm.model.gamma, f32),
        "sv_X": _host(sm.model.X, f32),
        "rho": _host(rho),
    }


def _manifest_meta(sm: ServingModel) -> dict:
    k = sm.spec.kernel
    return {
        "n_sv": int(sm.n_sv), "tn": int(sm.tn),
        "precision": sm.precision, "fit_iters": int(sm.fit_iters),
        "spec": {"nu1": float(sm.spec.nu1), "nu2": float(sm.spec.nu2),
                 "eps": float(sm.spec.eps),
                 "kernel": {"name": k.name, "gamma": float(k.gamma),
                            "coef0": float(k.coef0),
                            "degree": int(k.degree)}},
    }


def _model_from(manifest: dict, buf, device: torch.device) -> ServingModel:
    arrs: Dict[str, torch.Tensor] = {}
    for name, a in manifest["arrays"].items():
        bf16 = a["dtype"] == "bfloat16"
        dt = np.dtype(np.uint16) if bf16 else np.dtype(a["dtype"])
        count = int(np.prod(a["shape"])) if a["shape"] else 1
        view = np.frombuffer(buf, dtype=dt, count=count,
                             offset=a["offset"]).reshape(a["shape"])
        # .copy() is load-bearing: torch.from_numpy ALIASES the numpy
        # buffer, which would pin exported pointers into the mmap and
        # make the lease's close() raise BufferError. The bytes land
        # verbatim (same width, no cast): the bitwise-parity guarantee.
        t = torch.from_numpy(view.copy())
        if bf16:
            t = t.view(torch.int16).view(torch.bfloat16)
        arrs[name] = t.to(device)
    meta = manifest["meta"]
    spec = SlabSpec(nu1=meta["spec"]["nu1"], nu2=meta["spec"]["nu2"],
                    eps=meta["spec"]["eps"],
                    kernel=KernelFn(**meta["spec"]["kernel"]))
    model = OCSSVMModel(gamma=arrs["sv_gamma"], rho1=arrs["rho"][0],
                        rho2=arrs["rho"][1], X=arrs["sv_X"], spec=spec)
    return ServingModel(model=model, t_pad=arrs["t_pad"],
                        gamma_pad=arrs["gamma_pad"],
                        t_norms=arrs["t_norms"], n_sv=meta["n_sv"],
                        tn=meta["tn"], spec=spec,
                        precision=meta["precision"],
                        fit_iters=meta["fit_iters"])


# -- the store ----------------------------------------------------------------
def publish(sm: ServingModel, key: str, *,
            dir: Optional[str] = None) -> ShmLease:
    """Lay ``sm`` into shared memory under ``key``; returns the
    publisher's lease. Idempotent: publishing an already-published key
    just takes another lease on the existing segment (first writer
    wins — the key is a content fingerprint in the registry flow, so
    "same key" means "same bytes")."""
    from multiprocessing import shared_memory

    spool = _spool_dir(dir)
    dig = _digest(key)
    man_path = spool / f"{dig}.json"
    refs_path = spool / f"{dig}.refs"
    with _flock(spool / f"{dig}.lock"):
        existing = _attach_segment(man_path)
        if existing is not None:
            shm = existing
        else:
            arrays = _host_arrays(sm)
            offsets, total = {}, 0
            for name, (a, _) in arrays.items():
                total = -(-total // _ALIGN) * _ALIGN
                offsets[name] = total
                total += a.nbytes
            try:
                shm = shared_memory.SharedMemory(
                    create=True, size=max(total, 1), name=f"repro_{dig}")
            except FileExistsError:
                # orphan segment with no (usable) manifest — a publisher
                # crashed between shm_open and the manifest write.
                # Reclaim: unlink the corpse and recreate.
                stale = shared_memory.SharedMemory(name=f"repro_{dig}")
                stale.unlink()
                stale.close()
                shm = shared_memory.SharedMemory(
                    create=True, size=max(total, 1), name=f"repro_{dig}")
            _untrack(shm)
            for name, (a, _) in arrays.items():
                o = offsets[name]
                shm.buf[o:o + a.nbytes] = a.tobytes()
            manifest = {
                "format": _FORMAT, "key": key, "segment": shm.name,
                "nbytes": total, "meta": _manifest_meta(sm),
                "arrays": {n: {"offset": offsets[n],
                               "shape": list(a.shape),
                               "dtype": dtype}
                           for n, (a, dtype) in arrays.items()},
            }
            _atomic_write(man_path, json.dumps(manifest, indent=1))
        _add_ref(refs_path)
    return ShmLease(key=key, digest=dig, spool=spool, _shm=shm)


def attach(key: str, *, dir: Optional[str] = None,
           device=None) -> Tuple[ServingModel, ShmLease]:
    """Rebuild the ``ServingModel`` published under ``key`` from shared
    memory (no fit), its tensors on ``device`` (default: the CUDA card;
    raises without one unless ``device="cpu"``). Raises ``ShmKeyError``
    when nothing (healthy) is published. Hold the returned lease for the
    worker's lifetime."""
    from repro_torch.api import resolve_device
    dev = resolve_device(device)
    spool = _spool_dir(dir)
    dig = _digest(key)
    man_path = spool / f"{dig}.json"
    refs_path = spool / f"{dig}.refs"
    with _flock(spool / f"{dig}.lock"):
        shm = _attach_segment(man_path)
        if shm is None:
            # stale manifest (segment gone: publisher machine-rebooted
            # or unlinked out-of-band) — clean up so publish can retry
            man_path.unlink(missing_ok=True)
            refs_path.unlink(missing_ok=True)
            raise ShmKeyError(key)
        manifest = json.loads(man_path.read_text())
        model = _model_from(manifest, shm.buf, dev)
        _add_ref(refs_path)
    return model, ShmLease(key=key, digest=dig, spool=spool, _shm=shm)


def attach_or_publish(key: str, build: Callable[[], ServingModel], *,
                      dir: Optional[str] = None, device=None
                      ) -> Tuple[ServingModel, ShmLease]:
    """Attach if warm, else ``build()`` (the fit) and publish; an
    attached model lands on ``device`` (see ``attach``).

    The build runs under a separate cross-process lock, so N workers
    racing on a cold key pay exactly one fit: the winner fits while the
    rest block on the lock, then attach. The build lock is distinct
    from the store lock — a fit is seconds-long and must not block
    attaches/detaches of OTHER keys' leases (the store lock is per-key
    anyway) or health probes of this one.
    """
    spool = _spool_dir(dir)
    dig = _digest(key)
    try:
        return attach(key, dir=dir, device=device)
    except ShmKeyError:
        pass
    with _flock(spool / f"{dig}.build.lock"):
        try:        # a racer may have published while we waited
            return attach(key, dir=dir, device=device)
        except ShmKeyError:
            sm = build()
            lease = publish(sm, key, dir=dir)
            return sm, lease


def live_refs(key: str, *, dir: Optional[str] = None) -> int:
    """How many LIVE processes hold leases on ``key`` (dead pids are
    pruned from the count but only rewritten by attach/detach)."""
    spool = _spool_dir(dir)
    refs = _read_refs(spool / f"{_digest(key)}.refs")
    return sum(1 for p in refs if _pid_alive(p))


def _add_ref(refs_path: Path) -> None:
    # caller holds the store flock
    pids = [p for p in _read_refs(refs_path) if _pid_alive(p)]
    pids.append(os.getpid())
    _atomic_write(refs_path, json.dumps({"pids": pids}))


def _attach_segment(man_path: Path):
    """The manifest's segment, attached and untracked — or None when
    there is no (usable) publication. Caller holds the store flock."""
    from multiprocessing import shared_memory

    try:
        manifest = json.loads(man_path.read_text())
    except (FileNotFoundError, ValueError):
        return None
    try:
        shm = shared_memory.SharedMemory(name=manifest["segment"])
    except FileNotFoundError:
        return None
    _untrack(shm)   # attach REGISTERS on 3.8-3.12 too — see _untrack
    return shm
