"""Solver meshes over ``torch.distributed``: the launch layer's counterpart
of the JAX package's ``repro.launch.mesh``.

A mesh is a row-major grid of process ranks with named axes. Single pod:
(16, 16) = 256 ranks, axes ("data", "model"). Multi-pod: (2, 16, 16) =
512 ranks, axes ("pod", "data", "model") — the "pod" axis composes with
"data" for row sharding. ``make_solver_mesh`` scales the same axes down
to the ranks there are.

The port runs SPMD: one process per rank, each holding its slice of the
rows, every process calling the same solver with the same arguments. The
caller starts the processes and calls ``torch.distributed``'s
``init_process_group`` (with its address, world size, rank and a
``timeout=``) before building a mesh; nothing here initialises a process
group. With no process group a mesh has one rank, and its collectives
are identities — the JAX package's one-device case.

The backend is the caller's choice: NCCL when each rank has its own card,
gloo on the CPU or when ranks share a card (NCCL refuses two ranks on
one card).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist

__all__ = ["SolverMesh", "make_production_mesh", "make_test_mesh",
           "make_solver_mesh"]

# The timeout of every process group a mesh makes over a subset of the
# ranks: a rank that diverges (skips or adds a collective) then fails
# instead of hanging its peers. The world group has the caller's timeout.
GROUP_TIMEOUT = datetime.timedelta(seconds=300)


def _world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) with no process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(eq=False)
class SolverMesh:
    """A grid of process ranks with named axes, and this process's place
    in it.

    Not ``torch.distributed.device_mesh.DeviceMesh``, for three reasons:
    ``init_device_mesh`` initialises the default process group itself
    when none exists (a mesh here never does: no process group means one
    rank); the solver's collectives run over several axes at once
    (("pod", "data")), which needs a group over a flattened slice of a
    DeviceMesh, a private API; and each sub-group a DeviceMesh makes
    takes the backend's default timeout unless backend options are passed
    per axis, where a mesh here gives every group it makes
    ``GROUP_TIMEOUT``.

    ``ranks`` lists the global ranks in row-major order over ``shape``;
    ``rank`` is this process's global rank. ``shape`` maps each axis name
    to its size, in axis order (as ``jax.sharding.Mesh.shape`` does).
    """

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    ranks: Tuple[int, ...]
    rank: int
    _groups: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict, repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and shape "
                             f"{self.sizes} differ in length")
        if math.prod(self.sizes) != len(self.ranks):
            raise ValueError(f"mesh {self.sizes} needs {math.prod(self.sizes)}"
                             f" ranks, got {len(self.ranks)}")
        if self.rank not in self.ranks:
            raise ValueError(f"rank {self.rank} is not in the mesh's ranks "
                             f"{self.ranks}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Each axis's index of ``rank`` (default: this process)."""
        flat = self.ranks.index(self.rank if rank is None else rank)
        out = {}
        for ax, n in zip(reversed(self.axis_names), reversed(self.sizes)):
            out[ax] = flat % n
            flat //= n
        return {ax: out[ax] for ax in self.axis_names}

    def axis_rank(self, axes: Sequence[str]) -> int:
        """This process's row-major index over ``axes`` (the JAX package's
        ``_axis_rank``): its shard number when rows are split over them."""
        c = self.coords()
        r = 0
        for ax in axes:
            r = r * self.shape[ax] + c[ax]
        return r

    def group(self, axes: Sequence[str]):
        """The process group over ``axes`` that holds this rank: the ranks
        that share this rank's index on every other axis. ``None`` when
        no process group is initialised (one rank; collectives are
        identities); a one-rank slice of an initialised world still gets
        its group, so its collectives run through the backend.

        Every rank of the mesh must ask for the same axes at the same
        point (``new_subgroups_by_enumeration`` is collective over the
        world); the solver and scorer do, since every rank runs them with
        the same arguments. The group's rank order is the row-major order
        over ``axes``, so ``axes`` must appear in mesh order.
        """
        axes = tuple(axes)
        unknown = [ax for ax in axes if ax not in self.axis_names]
        if unknown:
            raise ValueError(f"mesh has no axis {unknown[0]!r}: "
                             f"{self.axis_names}")
        order = [self.axis_names.index(ax) for ax in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} must appear in mesh order "
                             f"{self.axis_names}")
        if not (dist.is_available() and dist.is_initialized()):
            return None
        if axes not in self._groups:
            slices: Dict[tuple, list] = {}
            for r in self.ranks:
                c = self.coords(r)
                key = tuple(c[ax] for ax in self.axis_names
                            if ax not in axes)
                slices.setdefault(key, []).append(r)
            lists = sorted(slices.values())
            _, world = _world()
            if lists == [list(range(world))]:
                group = dist.group.WORLD      # the caller's own timeout
            else:
                group, _ = dist.new_subgroups_by_enumeration(
                    lists, timeout=GROUP_TIMEOUT)
            self._groups[axes] = group
        return self._groups[axes]


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
          ranks: Optional[Sequence[int]] = None) -> SolverMesh:
    rank, world = _world()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    n = math.prod(shape)
    if len(ranks) < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {len(ranks)} — start "
            "that many processes and call torch.distributed."
            "init_process_group in each before building the mesh")
    return SolverMesh(tuple(axes), tuple(int(s) for s in shape),
                      ranks[:n], rank)


def make_production_mesh(*, multi_pod: bool = False) -> SolverMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over the first 256 / 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_test_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]
                   ) -> SolverMesh:
    """Small meshes for tests (e.g. (1, 1) or (2, 2)) over the first
    prod(shape) ranks."""
    return _mesh(tuple(shape), tuple(axes))


def make_solver_mesh(*, multi_pod: bool = False,
                     devices: Optional[Sequence[int]] = None):
    """Mesh + row-sharding axes for the distributed OCSSVM solver.

    ``devices``: the global ranks the mesh spans, in order (default:
    every rank of the process group; rank 0 alone without one). A set of
    ranks as large as a production pod gets ``make_production_mesh``;
    anything smaller gets the same axes scaled down: (n, 1) ("data",
    "model"), or (2, n/2, 1) ("pod", "data", "model") with ``multi_pod``
    (an even n >= 2).

    Returns ``(mesh, data_axes)``: the solver row-shards X, gamma and f
    over ``data_axes`` (("pod", "data") multi-pod, ("data",) otherwise);
    the "model" axis is left alone (every array is replicated over it).
    """
    rank, world = _world()
    ranks = tuple(range(world)) if devices is None else tuple(devices)
    data_axes = ("pod", "data") if multi_pod else ("data",)
    if len(ranks) >= math.prod((2, 16, 16) if multi_pod else (16, 16)):
        return make_production_mesh(multi_pod=multi_pod), data_axes
    n = len(ranks)
    if multi_pod:
        if n < 2 or n % 2:
            raise RuntimeError(
                f"multi_pod solver mesh needs an even device count >= 2, "
                f"found {n}")
        mesh = _mesh((2, n // 2, 1), ("pod", "data", "model"), ranks)
    else:
        mesh = _mesh((n, 1), ("data", "model"), ranks)
    return mesh, data_axes
