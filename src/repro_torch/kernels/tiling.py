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
pipelined narrow entries (``DEPTH`` cp.async stages); "simt", the
pipelined f32 tiles (gram's, and the f32 split class of decision and
fupdate's wide launches; ``BK = 8``, two stages); "wgmma", the
tensor-core kernels (``BK = WGMMA_K``, bf16/f16 only); "stream", the
16-bit split kernel with its first operand's tile streamed through the
ring instead of resident (:data:`STREAMED`, and decision's
:data:`STREAMED_WIDE`, whose 2-CTA clusters share the second operand's
chunks), for any d.

**Classes and the bitwise rule.** A launch may only take the menu
entries of its class (:func:`menu`), whose first entry is the class's
default, and every entry of a class gives bitwise the same output:

* ``decision``, and ``fupdate`` above S = 32 (its wide launches: the
  init pass, the warm reconcile and the warm refit's delta-scaled hot
  loop): the split design (``csrc/split_rows.cuh``). The second operand
  (support rows; the selected block) is split over CTAs in splits of
  SW = BN rows, each split's partial per row written to a workspace and
  the partials added in split order (:func:`decision_splits`,
  :func:`fupdate_splits`). The class is the rows' type: f32 launches take
  the SIMT entries (SW = 64, eight columns a thread, a shuffle tree over
  eight threads), bf16/f16 launches the wgmma entries (SW = 32, the
  fragment's columns, a shuffle tree over the quad). Entries of a class
  vary BM, TR, the ring's depth, the number of consumer warpgroups
  (BM / 64) and, for wgmma, the rows one wgmma covers (NW = 4 * TC, whole
  splits) and whether the first operand's tile is resident or streamed,
  which leave every sum's order alone. A resident 16-bit tile must fit
  in shared memory (:func:`wgmma_fits`): every launch takes an entry of
  its class that fits its d. The packed serving path chooses its entry
  by the bucket (:func:`packed_decision_config`).
* ``fupdate`` at S <= 32 (the solver's hot loop), every type: a row
  sum's order depends on BN and TC (which columns a thread adds, and the
  warp-shuffle tree over BN / TC threads), never on BM, TR, BK or the
  staging; each dot product is one thread's sequential FMA chain over
  the features (``csrc/kernel_rows.cuh``). So the class fixes BN = 32
  and TC = 2; the pipelined entries are its. A tuned fit is then bitwise
  a default one.
* ``gram``: the class is the rows' type. f32 launches take the SIMT
  entries ("tile", "simt"), each output one thread's FMA chain over the
  features in order, whatever the tile; bf16/f16 launches take the wgmma
  entries, each output the tensor cores' sum over k16 steps in feature
  order, whatever the tile width or the ring's depth.

Each source compiles each class for its types only (:func:`precisions_of`),
and a table row outside its precision's class is refused.

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

# The k-block of the wgmma entries: 64 16-bit features, one 128-byte
# swizzle row of a TMA tile.
WGMMA_K = 64

# The feature chunk of the pipelined f32 SIMT tiles (float4 loads).
SIMT_K = 8

# Dynamic shared memory a CTA may take on an H100 (``kMaxSmem``).
MAX_SMEM = 232448

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
    "default", "explicit", "table-exact", "table-nearest" or, for the
    packed decision path, "bucket")."""

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
                (64, 64, 8, 4, 8, 2), (128, 64, 8, 8, 8, 2),      # S > 32,
                (32, 64, 8, 4, 8, 2), (16, 64, 8, 4, 8, 2),       # f32
                (128, 32, 64, 2, 8, 4), (64, 32, 64, 2, 8, 4),    # S > 32,
                (128, 32, 64, 2, 16, 4), (128, 32, 64, 2, 32, 4),  # 16-bit
                (128, 32, 64, 2, 16, 3)),
    "decision": ((128, 64, 8, 8, 8, 2), (64, 64, 8, 4, 8, 2),     # f32
                 (32, 64, 8, 4, 8, 2), (16, 64, 8, 4, 8, 2),
                 (128, 32, 64, 2, 8, 4), (64, 32, 64, 2, 8, 4),   # wgmma
                 (128, 32, 64, 2, 16, 4), (128, 32, 64, 2, 32, 4),
                 (128, 32, 64, 2, 32, 2), (128, 32, 64, 2, 16, 3),
                 (128, 32, 64, 2, 64, 4)),
}

# The 16-bit split entry whose first operand's tile is streamed through
# the ring (``launch_stream``), not resident: no cap on d. decision and
# fupdate list it alike.
STREAMED = (128, 32, 64, 2, 16, 3)
# decision's wide streamed entry: chunks of NW = 256 support rows, each
# loaded once for a cluster of CLUSTER_CTAS neighbouring query tiles by
# TMA multicast; one CTA an SM (a ring of 4 stages of 48 KiB). A request
# at 4096 x 32768, d = 4096, bf16 pulls 8 GiB through L2 against
# STREAMED's 24 (``csrc/split_rows.cuh``). Not on fupdate's menu.
STREAMED_WIDE = (128, 32, 64, 2, 64, 4)
STREAMED_ENTRIES = (STREAMED, STREAMED_WIDE)
CLUSTER_CTAS = 2
# The packed and default decision launches take STREAMED_WIDE over
# STREAMED where its grid (decision_grid) has at least this many CTAs, one
# an SM: at d = 768-4096 on an H100 it was 1.2-2.3x faster at every shape
# timed from 72 CTAs up (72-96 included), and 0.70-0.89x as fast at most
# shapes of 32-68 CTAs, where STREAMED puts more CTAs on the card
# (PERF.md).
WIDE_MIN_CTAS = 72
FAMILIES = tuple(MENUS)


def config_of(entry, source: str = "default") -> TileConfig:
    """The TileConfig of a menu entry (BM, BN, BK, TR, TC, DEPTH)."""
    return TileConfig(*entry, source=source)


DEFAULT_CONFIGS = {
    "gram": config_of(MENUS["gram"][0]),              # f32
    "fupdate": config_of(MENUS["fupdate"][0]),        # S <= 32
    "decision": config_of(MENUS["decision"][0]),      # f32
}
GRAM_WGMMA_DEFAULT = config_of(MENUS["gram"][2])       # bf16, f16
DECISION_WGMMA_DEFAULT = config_of(MENUS["decision"][4])  # bf16, f16
FUPDATE_WIDE_DEFAULT = config_of(MENUS["fupdate"][5])  # S > 32, f32
FUPDATE_WGMMA_DEFAULT = config_of(MENUS["fupdate"][9])  # S > 32, 16-bit

# The tensor-core kernels (16-bit rows only).
WGMMA_KERNELS = ("wgmma", "stream")


def kernel_of(family: str, cfg: TileConfig) -> str:
    """The kernel a menu entry instantiates: "tile", "pipe", "simt",
    "wgmma" or "stream" (the ``launch_<kernel>`` of its case line)."""
    if cfg.block_k == WGMMA_K:
        return "stream" if cfg.entry in STREAMED_ENTRIES else "wgmma"
    if cfg.depth == 1:
        return "tile"
    return "simt" if cfg.block_k == SIMT_K else "pipe"


def precisions_of(family: str, cfg: TileConfig) -> Tuple[str, ...]:
    """The tile precisions the source compiles an entry for: the wgmma
    entries bf16/f16, the SIMT entries and gram's tile f32, fupdate's
    narrow entries ("tile", "pipe") all."""
    kind = kernel_of(family, cfg)
    if kind in WGMMA_KERNELS:
        return ("bf16", "f16")
    if kind == "simt" or family == "gram":
        return ("f32",)
    return PRECISIONS


def _class_key(family: str, cfg: TileConfig) -> tuple:
    """What a class fixes (the module docstring's bitwise rule): the kind
    of kernel for gram; the kind, SW = BN and (SIMT, row tile) TC for
    decision and fupdate."""
    wgmma = kernel_of(family, cfg) in WGMMA_KERNELS
    if family == "gram":
        return (wgmma,)
    return (wgmma, cfg.block_n, None if wgmma else cfg.tc)


def _streamed_entry(nq: int, nt: Optional[int]) -> tuple:
    """The streamed entry of a 16-bit decision launch of ``nq`` queries
    against ``nt`` support rows: :data:`STREAMED_WIDE` where its grid
    (:func:`decision_grid`) has :data:`WIDE_MIN_CTAS` CTAs, else (and
    when ``nt`` is not known) :data:`STREAMED`."""
    if nt is None:
        return STREAMED
    qtiles, groups = decision_grid(nq, nt, config_of(STREAMED_WIDE))
    return STREAMED_WIDE if qtiles * groups >= WIDE_MIN_CTAS else STREAMED


def wgmma_smem_bytes(cfg: TileConfig, d: int) -> int:
    """Dynamic shared memory of a 16-bit split entry at ``d`` features
    (``split_wgmma_smem_bytes`` of csrc/split_rows.cuh): the first
    operand's tile (resident: all its k-blocks of BM x 64; streamed: one a
    stage), the ring of NW = 4 * TC rows x 64 a stage, 1024 bytes of
    alignment slack and 2 DEPTH + 1 barriers."""
    k = WGMMA_K
    streamed = cfg.entry in STREAMED_ENTRIES
    blocks = cfg.depth if streamed else -(-int(d) // k)
    return (blocks * cfg.block_m * k * 2 + cfg.depth * 4 * cfg.tc * k * 2
            + 1024 + 8 * (2 * cfg.depth + 1))


def wgmma_fits(cfg: TileConfig, d: int) -> bool:
    """Whether a split launch of ``cfg`` at ``d`` features fits a CTA's
    shared memory: always for the SIMT and streamed entries; for a
    resident 16-bit tile, up to a padded d of 1664 at BM = 64, NW = 32,
    and 640 to 832 at BM = 128 (by NW and the ring's depth)."""
    if cfg.block_k != WGMMA_K:
        return True
    return wgmma_smem_bytes(cfg, d) <= MAX_SMEM


def _check_family(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"unknown kernel family {family!r}; "
                         f"expected one of {FAMILIES}")


def _sixteen_bit(precision: Optional[str]) -> bool:
    return precision is not None and check_precision(precision) != "f32"


def default_config(family: str, n: Optional[int] = None,
                   precision: Optional[str] = None,
                   d: Optional[int] = None,
                   m: Optional[int] = None) -> TileConfig:
    """The launch with no table: ``n`` is the selected block's size S for
    fupdate (narrow class up to 32) and the queries for decision,
    ``precision`` the rows' (the class of gram, decision and fupdate's
    wide launches; f32 when ``None``). With ``d``, the first entry of the
    class, from its default on, that fits ``d`` features
    (:func:`wgmma_fits`); for decision that is :data:`STREAMED`, or
    :data:`STREAMED_WIDE` where ``n`` queries against ``m`` support rows
    fill its grid."""
    _check_family(family)
    if family == "fupdate" and (n is None or n <= FUPDATE_NARROW_MAX_S):
        dflt = DEFAULT_CONFIGS["fupdate"]
    elif family == "fupdate":
        dflt = (FUPDATE_WGMMA_DEFAULT if _sixteen_bit(precision)
                else FUPDATE_WIDE_DEFAULT)
    elif _sixteen_bit(precision):
        dflt = (GRAM_WGMMA_DEFAULT if family == "gram"
                else DECISION_WGMMA_DEFAULT)
    else:
        dflt = DEFAULT_CONFIGS[family]
    if d is None or wgmma_fits(dflt, d):
        return dflt
    fit = next(config_of(c.entry) for c in _class_menu(family, dflt)
               if wgmma_fits(c, d))
    if family == "decision" and fit.entry == STREAMED and n is not None:
        return config_of(_streamed_entry(n, m))
    return fit


def menu(family: str, n: Optional[int] = None,
         precision: Optional[str] = None) -> Tuple[TileConfig, ...]:
    """The menu entries a launch of ``family`` (with S = ``n`` for
    fupdate, rows of ``precision``) may take: its class's, the default
    first."""
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


# The packed decision launch's entry by bucket (the largest bucket it
# serves, None: any), per class, the fastest on an H100 (PERF.md)
# among those that fill the card's 132 SMs against the served model's
# 8192 support rows (at 64 queries, f32: 2 query tiles x 128 splits of
# 64 rows; 16 bits: 1 x 256 chunks of 32 rows); larger buckets take
# larger query tiles (and 16 bits wider wgmma chunks), which read each
# support row fewer times.
_PACKED_DECISION = {
    "f32": ((64, (32, 64, 8, 4, 8, 2)), (None, (128, 64, 8, 8, 8, 2))),
    "wgmma": ((64, (64, 32, 64, 2, 8, 4)), (256, (128, 32, 64, 2, 8, 4)),
              (None, (128, 32, 64, 2, 32, 4))),
}
# A 16-bit entry whose resident query tile does not fit d gives way to
# the streamed one (STREAMED), also the faster where the resident tiles
# that still fit leave one CTA a SM: at d = 768, 4096 x 4096 queries x
# support, bf16, it took 0.1021 ms against 0.1233-0.3530 ms for the
# resident entries (PERF.md); and STREAMED to STREAMED_WIDE where the
# bucket and the support rows fill its grid (WIDE_MIN_CTAS).


def packed_decision_config(bucket: int, precision: str, d: int = LANE,
                           nt: Optional[int] = None) -> TileConfig:
    """The entry ``decision_packed`` launches for a padded query block of
    ``bucket`` rows of ``d`` features in ``precision`` against ``nt``
    support rows: one of the precision's class (so every bucket gives
    bitwise the same value for a query), chosen for speed by the bucket,
    or a streamed entry where that one's resident query tile does not fit
    d (:func:`wgmma_fits`): :data:`STREAMED_WIDE` where the launch fills
    its grid, else :data:`STREAMED` (also when ``nt`` is not given). The
    tuned table is not read."""
    precision = check_precision(precision)
    rule = _PACKED_DECISION["f32" if precision == "f32" else "wgmma"]
    entry = next(e for top, e in rule if top is None or bucket <= top)
    if not wgmma_fits(config_of(entry), d):
        entry = _streamed_entry(bucket, nt)
    return TileConfig(*entry, source="bucket")


def decision_splits(nt: int, cfg: TileConfig) -> int:
    """The support splits of a decision launch over ``nt`` support rows:
    ceil(nt / SW), SW = the entry's BN. The workspace is
    (splits, queries) f32."""
    return -(-int(nt) // cfg.block_n)


def fupdate_splits(s: int, cfg: TileConfig) -> int:
    """The splits of the selected block of a fupdate launch over ``s``
    rows: ceil(s / SW) for the wide classes' split kernels, SW = the
    entry's BN; 0 for the narrow class, which writes no workspace. The
    workspace is (splits, m) f32."""
    if kernel_of("fupdate", cfg) in ("tile", "pipe"):
        return 0
    return decision_splits(s, cfg)


def wide_clusters(sms: int = 132) -> int:
    """The clusters of :data:`STREAMED_WIDE` a card of ``sms`` SMs holds
    at once, one CTA an SM, when all its SMs pair up; the launcher asks
    the card (``cudaOccupancyMaxActiveClusters``), and
    ``ops.wide_clusters`` gives the card's answer to hold against this."""
    return sms // CLUSTER_CTAS


def decision_grid(nq: int, nt: int, cfg: TileConfig, sms: int = 132,
                  per_sm: int = 4) -> Tuple[int, int]:
    """(query tiles, split groups) of a decision launch's grid, as
    ``csrc/decision.cu``'s launchers lay it out on a card of ``sms`` SMs:
    a SIMT CTA takes one split; the wgmma launcher gives each CTA a run
    of chunks of NW = 4 * TC support rows, with as many CTAs as the SMs
    hold at once (``per_sm`` a SM; the launcher asks the runtime), so
    that a CTA loads its query tile once for its run; for
    :data:`STREAMED_WIDE` one CTA an SM, its query tiles rounded up to
    whole clusters (a partner past the last tile computes nothing), and
    :func:`wide_clusters` clusters."""
    qtiles = -(-int(nq) // cfg.block_m)
    if cfg.block_k != WGMMA_K:
        return qtiles, decision_splits(nt, cfg)
    chunks = -(-int(nt) // (4 * cfg.tc))
    if chunks == 0:
        return qtiles, 0
    if cfg.entry == STREAMED_WIDE:
        pairs = -(-qtiles // CLUSTER_CTAS)
        groups = min(max(wide_clusters(sms) // pairs, 1), chunks)
        per_cta = -(-chunks // groups)
        return pairs * CLUSTER_CTAS, -(-chunks // per_cta)
    groups = min(-(-per_sm * sms // qtiles), chunks)
    per_cta = -(-chunks // groups)
    return qtiles, -(-chunks // per_cta)


def _pad_to(a: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``a`` up to a multiple of ``mult``."""
    pad = (-a.shape[axis]) % mult
    if pad == 0:
        return a
    axis = axis % a.ndim
    # F.pad lists (left, right) pairs from the LAST axis backwards.
    widths = [0, 0] * (a.ndim - axis - 1) + [0, pad]
    return F.pad(a, widths)


# 16-bit features a TMA row stride is a multiple of (16 bytes).
TMA_FEATURES = 8


def tma_rows(a: torch.Tensor) -> torch.Tensor:
    """16-bit rows as TMA reads them: the features zero-padded to a
    multiple of :data:`TMA_FEATURES`, on a 16-byte aligned base (the
    same tensor when it already is)."""
    a = _pad_to(a, TMA_FEATURES, axis=1)
    return a.clone() if a.data_ptr() % 16 else a


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
    allowed = {c.entry for c in _class_menu(family, dflt)
               if wgmma_fits(c, d)}
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
    class may take (S = ``n`` for fupdate, ``precision``) that fit ``d``;
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
    table. Every way returns an entry that fits ``d``
    (:func:`wgmma_fits`). See the module docstring for the full
    precedence (the packed decision path does not come here:
    :func:`packed_decision_config`).
    """
    default = default_config(family, n, precision, d, m)
    if block_m is not None or block_n is not None or block_k is not None:
        cls = [c for c in menu(family, n, precision) if wgmma_fits(c, d)]
        want = (block_m if block_m is not None else default.block_m,
                block_n if block_n is not None else default.block_n,
                block_k if block_k is not None else default.block_k)
        fits = [c for c in cls if (c.block_m, c.block_n, c.block_k) == want]
        if not fits:
            raise ValueError(
                f"no {family} menu entry (csrc/{family}.cu) has block "
                f"sizes (m, n, k) = {want}"
                + (f" for S = {n}" if family == "fupdate" else "")
                + f" for {precision} rows of {d} features"
                + f"; the launch may take {[c.entry for c in cls]}")
        same_tile = [c for c in fits if (c.tr, c.tc, c.depth)
                     == (default.tr, default.tc, default.depth)]
        return (same_tile or fits)[0]
    if _no_autotune():
        return default
    tuned = lookup_tuned(family, m, d, precision, backend, n)
    return tuned if tuned is not None else default
