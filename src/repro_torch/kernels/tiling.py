"""Shared tile plumbing for the kernel wrappers: padding, and the launch
configuration of every CUDA kernel (its menu and the tuned table).

**Menus.** Each ``csrc/<family>.cu`` compiles a menu: a list of template
instantiations ``<BM, BN, BK, TR, TC, DEPTH>`` — rows of the first
operand per CTA, rows of the second per chunk (gram: per CTA), the
feature depth of a staged chunk, the ``TR x TC`` register tile of each
thread and the number of shared-memory stages. :data:`MENUS` lists them
in the order of the source's ``case`` lines; a launch passes the index of
its entry, and the C entry refuses any other index with
``cudaErrorInvalidValue`` (so a menu out of step with its source raises
on the card; the CPU tests also read the ``case`` lines). A
:class:`TileConfig` is one entry (``block_m`` = BM, ``block_n`` = BN,
``block_k`` = BK, ``tr``, ``tc``, ``depth``) and :func:`kernel_of` names
the kernel it instantiates (the ``launch_<kernel>`` of its case line):
"tile", the one-stage dot tile at ``BK = DK``; "pipe", fupdate's
pipelined entries (``DEPTH`` cp.async stages); "simt", gram's pipelined
f32 tile (two stages); "wgmma", gram's tensor-core kernel
(``BK = WGMMA_K``, bf16/f16 only).

**Classes and the bitwise rule.** A launch may only take the menu
entries of its class (:func:`menu`), whose first entry is the class's
default, and every entry of a class gives bitwise the same output:

* ``fupdate`` and ``decision``: a row sum's order depends on BN and TC
  (which columns a thread adds, and the warp-shuffle tree over BN / TC
  threads), never on BM, TR, BK or the staging; each dot product is one
  thread's sequential FMA chain over the features
  (``csrc/kernel_rows.cuh``). So a class fixes BN and TC. ``fupdate`` has
  two classes by the selected block's size S: BN = 32 for S <= 32 (the
  solver's hot loop; the pipelined entries are this class's) and BN = 64
  above (the init pass and the warm reconcile), each with its own
  default. A tuned fit is then bitwise a default one.
* ``gram``: the class is the rows' type. f32 launches take the SIMT
  entries ("tile", "simt"), each output one thread's FMA chain over the
  features in order, whatever the tile; bf16/f16 launches take the wgmma
  entries, each output the tensor cores' sum over k16 steps in feature
  order, whatever the tile width or the ring's depth. The source compiles
  each class for its types only (:func:`precisions_of`), and a table row
  outside its precision's class is refused.

**Resolution** (:func:`resolve_tiles`, called by each wrapper on CUDA
tensors), highest precedence first:

1. explicit ``tm=/tn=/tk=`` kwargs at the call site — passing ANY of them
   opts the call out of the tuned table entirely: the unset rest come
   from the class's default, and the class's menu entry with those block
   sizes (preferring the default's register tile and depth) is launched;
   none raises;
2. ``REPRO_NO_AUTOTUNE=1`` in the environment forces the defaults;
3. the tuned table ``tuned_configs.json`` beside this file, written by
   ``python -m repro_torch.kernels.autotune --update-table`` on an H100:
   rows keyed on ``(family, m, d, precision, backend)``, the exact key or
   else the nearest one within :data:`NEAREST_MAX_DIST` (a tie going to
   the larger m), among the rows the launch's class may take;
4. the class's default (:func:`default_config`) — with an empty table
   every launch is its class's first entry.

Unlike the JAX package, nothing is traced: each launch resolves its
config when it is called, so a table installed by :func:`set_tuned_table`
steers the very next launch of any shape (the JAX package's "already
traced shapes keep their config" does not hold here). The parsed table
and the lookups are memoized until the next :func:`set_tuned_table` or
``autotune.write_table``; an edit of the file by any other means is seen
by a new process. CPU tensors run the plain versions, which take no
tiles.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.precision import PRECISIONS, check_precision

# Feature and row padding multiple the packed serving operands keep, so a
# packed model has the same geometry as the JAX package's.
LANE = 128

# Feature-chunk depth of the dot tile and of fupdate's pipelined entries
# (``DK`` in csrc/kernel_rows.cuh).
DK = 32

# The k-block of gram's wgmma entries: 64 16-bit features, one 128-byte
# swizzle row of a TMA tile.
WGMMA_K = 64

# Nearest-shape fallback cap: |log2(m/m')| + |log2(d/d')| beyond which a
# table entry is considered too far from the requested shape to trust.
NEAREST_MAX_DIST = 2.0

# The committed table of "cuda" rows.
TUNED_TABLE_PATH = Path(__file__).resolve().parent / "tuned_configs.json"

# A fupdate launch with more selected rows than this takes the wide class.
FUPDATE_NARROW_MAX_S = 32


@dataclass(frozen=True)
class TileConfig:
    """One launch shape: a menu entry, and how it was chosen (``source``:
    "default", "explicit", "table-exact" or "table-nearest")."""

    block_m: int
    block_n: int
    block_k: int
    tr: int
    tc: int
    depth: int = 1
    source: str = "default"

    @property
    def entry(self) -> Tuple[int, int, int, int, int, int]:
        """The (BM, BN, BK, TR, TC, DEPTH) of the source's menu line."""
        return (self.block_m, self.block_n, self.block_k, self.tr, self.tc,
                self.depth)


# (BM, BN, BK, TR, TC, DEPTH) per launch index, in the order of each
# source's ``case`` lines. The first entry of each class is its default.
MENUS = {
    "gram": ((64, 64, 32, 4, 4, 1), (128, 128, 8, 8, 8, 2),       # f32
             (128, 256, 64, 2, 64, 3), (128, 256, 64, 2, 64, 2),  # wgmma
             (128, 128, 64, 2, 32, 4)),
    "fupdate": ((64, 32, 32, 4, 2, 1), (16, 32, 32, 1, 2, 1),     # S <= 32
                (64, 32, 32, 4, 2, 4), (32, 32, 32, 2, 2, 4),
                (16, 32, 32, 1, 2, 4),
                (32, 64, 32, 2, 4, 1), (16, 64, 32, 1, 4, 1),     # S > 32
                (16, 64, 32, 2, 4, 1), (64, 64, 32, 4, 4, 1)),
    "decision": ((16, 64, 32, 1, 4, 1), (8, 64, 32, 1, 4, 1),
                 (32, 64, 32, 2, 4, 1), (32, 64, 32, 1, 4, 1),
                 (64, 64, 32, 4, 4, 1), (16, 64, 32, 2, 4, 1)),
}
FAMILIES = tuple(MENUS)


def config_of(entry, source: str = "default") -> TileConfig:
    """The TileConfig of a menu entry (BM, BN, BK, TR, TC, DEPTH)."""
    return TileConfig(*entry, source=source)


DEFAULT_CONFIGS = {
    "gram": config_of(MENUS["gram"][0]),              # f32
    "fupdate": config_of(MENUS["fupdate"][0]),        # S <= 32
    "decision": config_of(MENUS["decision"][0]),
}
GRAM_WGMMA_DEFAULT = config_of(MENUS["gram"][2])       # bf16, f16
FUPDATE_WIDE_DEFAULT = config_of(MENUS["fupdate"][5])  # S > 32


def kernel_of(family: str, cfg: TileConfig) -> str:
    """The kernel a menu entry instantiates: "tile", "pipe", "simt" or
    "wgmma" (the ``launch_<kernel>`` of its case line)."""
    if cfg.block_k == WGMMA_K:
        return "wgmma"
    if cfg.depth == 1:
        return "tile"
    return "simt" if family == "gram" else "pipe"


def precisions_of(family: str, cfg: TileConfig) -> Tuple[str, ...]:
    """The tile precisions the source compiles an entry for: gram's wgmma
    entries bf16/f16, its SIMT entries f32, every other entry all."""
    if family != "gram":
        return PRECISIONS
    return (("bf16", "f16") if kernel_of(family, cfg) == "wgmma"
            else ("f32",))


def _class_key(family: str, cfg: TileConfig) -> tuple:
    """What a class fixes (the module docstring's bitwise rule): the kind
    of kernel for gram, BN and TC for the row-sum kernels."""
    if family == "gram":
        return (kernel_of(family, cfg) == "wgmma",)
    return (cfg.block_n, cfg.tc)


def _check_family(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"unknown kernel family {family!r}; "
                         f"expected one of {FAMILIES}")


def default_config(family: str, n: Optional[int] = None,
                   precision: Optional[str] = None) -> TileConfig:
    """The launch with no table: ``n`` is the selected block's size S for
    fupdate (its class), ``precision`` the rows' for gram (its class; f32
    when ``None``); neither is read for the other families."""
    _check_family(family)
    if family == "fupdate" and n is not None and n > FUPDATE_NARROW_MAX_S:
        return FUPDATE_WIDE_DEFAULT
    if family == "gram" and precision is not None \
            and check_precision(precision) != "f32":
        return GRAM_WGMMA_DEFAULT
    return DEFAULT_CONFIGS[family]


def menu(family: str, n: Optional[int] = None,
         precision: Optional[str] = None) -> Tuple[TileConfig, ...]:
    """The menu entries a launch of ``family`` (with S = ``n`` for
    fupdate, rows of ``precision`` for gram) may take: its class's."""
    return _class_menu(family, default_config(family, n, precision))


@lru_cache(maxsize=None)
def _class_menu(family: str, dflt: TileConfig) -> Tuple[TileConfig, ...]:
    key = _class_key(family, dflt)
    cfgs = (config_of(e, "explicit") for e in MENUS[family])
    return tuple(c for c in cfgs if _class_key(family, c) == key)


def menu_index(family: str, cfg: TileConfig) -> int:
    """The launch index of ``cfg`` in its family's source."""
    _check_family(family)
    if cfg.entry not in MENUS[family]:
        raise ValueError(f"{cfg} is not on the {family} menu "
                         f"(csrc/{family}.cu): {MENUS[family]}")
    return MENUS[family].index(cfg.entry)


def _pad_to(a: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``a`` up to a multiple of ``mult``."""
    pad = (-a.shape[axis]) % mult
    if pad == 0:
        return a
    axis = axis % a.ndim
    # F.pad lists (left, right) pairs from the LAST axis backwards.
    widths = [0, 0] * (a.ndim - axis - 1) + [0, pad]
    return F.pad(a, widths)


def _no_autotune() -> bool:
    """REPRO_NO_AUTOTUNE=1 disables the tuned table (read at each launch)."""
    return os.environ.get("REPRO_NO_AUTOTUNE", "").strip().lower() in (
        "1", "true", "on")


def backend_name(t) -> str:
    """The backend key a launch tunes under: the device type of a tensor
    or device ("cuda" for the card). The table holds "cuda" rows only."""
    dev = t.device if isinstance(t, torch.Tensor) else torch.device(t)
    return dev.type


# ---------------------------------------------------------------------------
# tuned-table loading + validation
# ---------------------------------------------------------------------------

_REQUIRED_ENTRY_KEYS = ("family", "m", "d", "precision", "backend",
                        "block_m", "block_n", "block_k", "tr", "tc",
                        "depth")

# Test hook: a dict/path installed via set_tuned_table, or None for the
# committed TUNED_TABLE_PATH.
_table_override = None


def row_config(e: dict, source: str = "default") -> TileConfig:
    """The TileConfig a table row (or a sweep's winner row) names."""
    return TileConfig(e["block_m"], e["block_n"], e["block_k"], e["tr"],
                      e["tc"], e["depth"], source)


def _validate_entry(e: dict) -> dict:
    missing = [k for k in _REQUIRED_ENTRY_KEYS if k not in e]
    if missing:
        raise ValueError(f"tuned-table entry missing keys {missing}: {e}")
    fam = e["family"]
    if fam not in FAMILIES:
        raise ValueError(f"tuned-table entry has unknown family {fam!r} "
                         f"(expected one of {FAMILIES}): {e}")
    cfg = row_config(e)
    if not all(isinstance(v, int) for v in cfg.entry):
        raise ValueError(f"tuned-table entry needs int block sizes: {e}")
    menu_index(fam, cfg)          # raises off the menu
    if check_precision(e["precision"]) not in precisions_of(fam, cfg):
        raise ValueError(f"tuned-table entry names a {fam} entry outside "
                         f"the class of {e['precision']} rows: {e}")
    if not (isinstance(e["m"], int) and isinstance(e["d"], int)
            and e["m"] > 0 and e["d"] > 0):
        raise ValueError(f"tuned-table entry needs positive int m/d: {e}")
    return e


def validate_table(doc: dict) -> tuple:
    """The validated entries of a table document; raises ValueError on
    the first bad one."""
    if not isinstance(doc, dict) or "entries" not in doc:
        raise ValueError("tuned table must be a dict with an 'entries' list")
    return tuple(_validate_entry(dict(e)) for e in doc["entries"])


@lru_cache(maxsize=None)
def _load_table_file(path_str: str) -> tuple:
    with open(path_str) as fh:
        return validate_table(json.load(fh))


def clear_caches() -> None:
    """Forget the parsed table and the memoized lookups."""
    _load_table_file.cache_clear()
    _lookup.cache_clear()


def set_tuned_table(table) -> None:
    """Install a tuned table for this process.

    ``table`` is a dict in the ``tuned_configs.json`` format, a path to
    one, or ``None`` to restore the committed table. Dicts are validated
    here (a broken table fails at once, not at the first launch). The
    next launch of any shape resolves against it.
    """
    global _table_override
    if isinstance(table, dict):
        validate_table(table)   # eager validation
    _table_override = table
    clear_caches()


def _table_entries() -> tuple:
    src = _table_override
    if src is None:
        if not TUNED_TABLE_PATH.exists():
            return ()
        return _load_table_file(str(TUNED_TABLE_PATH))
    if isinstance(src, (str, Path)):
        return _load_table_file(str(src))
    return validate_table(src)


def nearest_entry(entries: Sequence[dict], family: str, m: int, d: int,
                  precision: str, backend: str,
                  allowed=None) -> Optional[Tuple[dict, float]]:
    """(entry, distance) of the same-(family, precision, backend) entry
    nearest to (m, d) by |log2 m ratio| + |log2 d ratio| within
    :data:`NEAREST_MAX_DIST`, on a tie the larger tuned m (closer to the
    asymptotic regime); ``allowed`` restricts the entries to those menu
    entries (BM, BN, BK, TR, TC, DEPTH). ``None`` if there is none."""
    best = None
    best_dist = None
    for e in entries:
        if (e["family"] != family or e["precision"] != precision
                or e["backend"] != backend):
            continue
        if allowed is not None and row_config(e).entry not in allowed:
            continue
        dist = (abs(math.log2(max(m, 1) / e["m"]))
                + abs(math.log2(max(d, 1) / e["d"])))
        if dist > NEAREST_MAX_DIST:
            continue
        if (best is None or dist < best_dist
                or (dist == best_dist and e["m"] > best["m"])):
            best, best_dist = e, dist
    return None if best is None else (best, best_dist)


@lru_cache(maxsize=4096)
def _lookup(family: str, m: int, d: int, precision: str, backend: str,
            dflt: TileConfig) -> Optional[TileConfig]:
    allowed = {c.entry for c in _class_menu(family, dflt)}
    hit = nearest_entry(_table_entries(), family, m, d, precision, backend,
                        allowed)
    if hit is None:
        return None
    e, dist = hit
    return row_config(e, "table-exact" if dist == 0.0 else "table-nearest")


def lookup_tuned(family: str, m: int, d: int, precision: str, backend: str,
                 n: Optional[int] = None) -> Optional[TileConfig]:
    """The table's config for a launch of ``family`` at (m, d) — exact
    key, else nearest (see :func:`nearest_entry`) — among the entries its
    class may take (S = ``n`` for fupdate, ``precision`` for gram);
    ``None`` if there is none."""
    return _lookup(family, int(m), int(d), precision, backend,
                   default_config(family, n, precision))


def resolve_tiles(family: str, *, m: int, d: int, precision: str,
                  backend: str, n: Optional[int] = None,
                  block_m: Optional[int] = None,
                  block_n: Optional[int] = None,
                  block_k: Optional[int] = None) -> TileConfig:
    """Pick the launch config for one kernel call.

    ``m``/``d`` are the family's table key: the streamed-majority row
    count (gram: max(M, N); fupdate: the X rows; decision: the support
    rows) and the feature dim; ``n`` is fupdate's selected block size S
    and ``precision`` the rows' (their classes). ``block_*`` are the
    wrapper's explicit kwargs — any of them being set wins over the
    table. See the module docstring for the full precedence.
    """
    default = default_config(family, n, precision)
    if block_m is not None or block_n is not None or block_k is not None:
        cls = menu(family, n, precision)
        want = (block_m if block_m is not None else default.block_m,
                block_n if block_n is not None else default.block_n,
                block_k if block_k is not None else default.block_k)
        fits = [c for c in cls if (c.block_m, c.block_n, c.block_k) == want]
        if not fits:
            raise ValueError(
                f"no {family} menu entry (csrc/{family}.cu) has block "
                f"sizes (m, n, k) = {want}"
                + (f" for S = {n}" if family == "fupdate" else "")
                + (f" for {precision} rows" if family == "gram" else "")
                + f"; the launch may take {[c.entry for c in cls]}")
        same_tile = [c for c in fits if (c.tr, c.tc, c.depth)
                     == (default.tr, default.tc, default.depth)]
        return (same_tile or fits)[0]
    if _no_autotune():
        return default
    tuned = lookup_tuned(family, m, d, precision, backend, n)
    return tuned if tuned is not None else default
