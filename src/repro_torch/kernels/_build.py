"""Build and bind the hand-written CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared
library with a plain C entry point::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

and is loaded with ``ctypes``. The library's name carries a hash of the
sources and flags, so an edited kernel rebuilds and a built one is
reused. ``build()`` starts one ``nvcc`` per source, all together.

A ``Kernel`` is the binding of one C entry point: its ``argtypes`` are
``c_void_p`` for every pointer and the stream (an undeclared pointer
would be cut to 32 bits), ``c_int`` for ints and ``c_float`` for the
kernel scalars; the entry returns ``cudaGetLastError()`` and ``launch``
raises when it is not 0 — a refused launch never runs and reports
nothing otherwise. ``Kernel.launches`` counts successful launches,
``Kernel.by_entry`` the same launches by the menu entry of their tile
config (its class tells, e.g., fupdate's narrow launches from its wide
ones), and ``Kernel.last_config`` holds the tile config
(``tiling.TileConfig``) of the last one.

A ``Launch`` is one launch with its C arguments marshalled: the kernel
wrappers build it from prepared operands and call it; calling it again
relaunches into the same output (how ``chip_smoke.py`` times a kernel
without the wrapper's casts and norms).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# <repo>/build/repro_torch (this file is <repo>/src/repro_torch/kernels/).
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_build_lock = threading.Lock()


@dataclass
class Built:
    """One compiled source: its library, the build's wall seconds (0 when
    an up-to-date library was reused) and ptxas's resource lines (with
    each function's stack frame and spill line)."""

    path: Path
    seconds: float = 0.0
    ptxas: list = field(default_factory=list)


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH);"
                       " the CUDA kernels are built from csrc/ at first use")


def sources() -> list:
    """The kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Compile the named sources (default: all) that have no up-to-date
    library, one ``nvcc`` process per source started together; raises
    with the compiler's output if any fails."""
    names = list(sources() if names is None else names)
    out: Dict[str, Built] = {}
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in names:
            lib = library_path(name)
            if lib.exists():
                out[name] = Built(lib)
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, lib)
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (exit {proc.returncode})\n"
                              f"{log}")
                os.unlink(tmp)
                continue
            os.replace(tmp, lib)     # atomic: concurrent builders agree
            out[name] = Built(lib, time.perf_counter() - t0,
                              [ln.strip() for ln in log.splitlines()
                               if "ptxas" in ln or "spill" in ln])
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


class Kernel:
    """The ctypes binding of one C entry point of ``csrc/<source>.cu``.

    The library is built and loaded at the first ``launch`` (never at
    import: the CPU-only tests import every module).
    """

    def __init__(self, source: str, entry: str, argtypes: Sequence):
        self.source = source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.launches = 0
        self.by_entry = Counter()
        self.last_config = None
        self._fn = None
        self._err_str = None
        self._lock = threading.Lock()

    def load(self):
        with self._lock:
            if self._fn is None:
                lib = ctypes.CDLL(str(build([self.source])[self.source].path))
                fn = getattr(lib, self.entry)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err_str = getattr(lib, f"{self.source}_error_string")
                err_str.argtypes = [ctypes.c_int]
                err_str.restype = ctypes.c_char_p
                self._lib, self._err_str, self._fn = lib, err_str, fn
        return self._fn

    def launch(self, *args, config=None) -> None:
        err = self.load()(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.entry} failed: CUDA error {err} "
                f"({self._err_str(err).decode()})")
        self.launches += 1
        if config is not None:
            self.by_entry[config.entry] += 1

    def reset_counts(self) -> None:
        self.launches = 0
        self.by_entry.clear()


@dataclass(frozen=True)
class Launch:
    """One launch of ``kernel`` with its C arguments ``args`` (the menu
    index of ``config`` among them), on the card ``device`` whose stream
    they name, writing ``out`` (and ``scratch``, a workspace the launch
    keeps alive). Calling it launches the kernel (counted) with that card
    current, then restores the caller's current card, and returns
    ``out``."""

    kernel: Kernel
    device: int
    args: tuple
    out: object
    config: object = None
    scratch: object = None

    def __call__(self):
        with torch.cuda.device(self.device):
            self.kernel.launch(*self.args, config=self.config)
        self.kernel.last_config = self.config
        return self.out
