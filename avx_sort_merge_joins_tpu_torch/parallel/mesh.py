"""A mesh of N shards on one torch device, its collectives, and the
exchange-scheduling strategies (counterpart of
``avx_sort_merge_joins_tpu/parallel/mesh.py:28-175``; reference:
src/util/cpu_mapping.c and src/util/numa_shuffle.c:55-85).

The JAX package runs its distributed joins on a mesh of devices, in its
tests 8 virtual CPU devices in one process.  The port's mesh is their
counterpart on one card: N shards whose tensors all live on one
``torch.device``.  A shard's data is row ``me`` of a stacked ``(n, ...)``
tensor, and the collectives are device-side copies of those stacks:

* ``all_to_all``: ``(n, n * k)`` -> ``(n, n, k)`` -> swap the first two
  axes, so that piece d of shard s lands as piece s of shard d
  (``all_to_all_row``: one member's share alone);
* ``all_gather``: every shard's row, concatenated in rank order;
* ``ppermute``: row ``src`` moves to row ``dst`` for each pair of a
  permutation, the rounds of the scheduled exchange.

A 2-D ``(host, chip)`` mesh keeps the flat rank ``h * chips_per_host + c``
and addresses either axis alone, as the JAX mesh's axis names do.  A
backend of process groups (one shard per card) can take the place of these
methods; it is not here.

Not ported: ``mesh_from_mapping_file`` and the ``DEFAULT_MESH`` it installs
(the CLI refuses ``--mapping-file``), and ``sharding``/``replicated`` (a
stacked tensor on one device is its own layout).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..types import NumaStrategy, default_device

AXIS = "chips"
HOST_AXIS = "host"

# Host (NUMA-region) granularity of the flat shard list, the "threads per
# region" that the RING shuffle strides by.  Module state, as in the JAX
# package (mesh.py:31-36): ``make_mesh(chips_per_host=...)`` installs it
# for every later mesh of the process.
HOST_GRANULARITY: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n`` shards on ``device``; ``hosts`` is ``(n_hosts,
    chips_per_host)`` for a 2-D mesh and None for a flat one."""

    n: int
    device: torch.device
    hosts: Optional[tuple[int, int]] = None

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (HOST_AXIS, AXIS) if self.hosts else (AXIS,)

    def _check_stack(self, x: torch.Tensor, name: str) -> None:
        if x.dim() < 1 or x.shape[0] != self.n:
            raise ValueError(f"{name}: leading axis {tuple(x.shape)} is not "
                             f"the mesh's {self.n} shards")
        if x.device != self.device:
            raise ValueError(f"{name}: tensor on {x.device}, mesh on "
                             f"{self.device}")

    def all_to_all(self, x: torch.Tensor,
                   axis: Optional[str] = None) -> torch.Tensor:
        """Tiled all-to-all of a stacked ``(n, m)`` tensor: shard s's row
        is cut into as many pieces as the axis has members, piece d goes
        to member d, and member d keeps the pieces in source order.
        ``axis=None`` is the whole (flat) mesh; on a 2-D mesh ``AXIS``
        exchanges within each host and ``HOST_AXIS`` across hosts.  The
        result is a new contiguous stack, as a collective's receive buffer
        is (with one element a piece, ``reshape`` would return a strided
        view)."""
        self._check_stack(x, "all_to_all")
        m = x[0].numel()
        if not self.hosts or axis is None:
            y = x.reshape(self.n, self.n, m // self.n).transpose(0, 1)
        else:
            H, C = self.hosts
            if axis == AXIS:
                y = x.reshape(H, C, C, m // C).transpose(1, 2)
            else:
                y = x.reshape(H, C, H, m // H).permute(2, 1, 0, 3)
        return y.contiguous().reshape(self.n, m)

    def all_to_all_row(self, x: torch.Tensor, d: int) -> torch.Tensor:
        """What member ``d`` receives from a tiled all-to-all of the stacked
        ``(n, m)`` tensor over the whole mesh: ``all_to_all(x)[d]``, a new
        contiguous column, built alone.  Taking the rows one at a time
        keeps one receive buffer, not the whole stack, on the device."""
        self._check_stack(x, "all_to_all_row")
        m = x[0].numel()
        return x.reshape(self.n, self.n, m // self.n)[:, d].reshape(m)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's row concatenated in flat rank order: what each
        shard of an all-gather over the whole mesh receives."""
        self._check_stack(x, "all_gather")
        return x.reshape(-1)

    def ppermute(self, x: torch.Tensor, perm,
                 axis: Optional[str] = None) -> torch.Tensor:
        """One collective-permute round: for each ``(src, dst)`` pair of
        axis members, member dst receives member src's row; members that
        receive nothing get zeros.  On a 2-D mesh the pairs name hosts
        (``HOST_AXIS``) or chips within a host (``AXIS``)."""
        self._check_stack(x, "ppermute")
        src = torch.tensor([p[0] for p in perm], device=x.device)
        dst = torch.tensor([p[1] for p in perm], device=x.device)
        out = torch.zeros_like(x)
        if self.hosts and axis == HOST_AXIS:  # [host, chip, ...]
            out.view(*self.hosts, -1)[dst] = x.view(*self.hosts, -1)[src]
        else:  # [host or 1, member, ...]
            outer = self.hosts[0] if self.hosts and axis == AXIS else 1
            out.view(outer, self.n // outer, -1)[:, dst] = \
                x.view(outer, self.n // outer, -1)[:, src]
        return out


def _mesh_device(device) -> torch.device:
    """``device``, or the card by default, with its index: tensors made on
    ``"cuda"`` land on ``cuda:<current>``, and the collectives compare the
    two."""
    device = torch.device(device) if device is not None else default_device()
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n: int, device=None,
              chips_per_host: Optional[int] = None) -> Mesh:
    """Flat mesh of ``n`` shards on ``device`` (default: the card, see
    :func:`default_device`).  Unlike the JAX ``make_mesh``, which takes the
    first ``n`` of the devices it finds (``mesh.py:51-52``) and so builds a
    smaller mesh when there are fewer, this mesh always has ``n`` shards.
    ``chips_per_host`` installs the topology's host granularity."""
    global HOST_GRANULARITY
    if n < 1:
        raise ValueError(f"make_mesh: {n} shards")
    if chips_per_host is not None:
        HOST_GRANULARITY = chips_per_host
    return Mesh(int(n), _mesh_device(device))


def make_mesh2d(n_hosts: int, chips_per_host: int, device=None) -> Mesh:
    """2-D ``(host, chip)`` mesh of ``n_hosts * chips_per_host`` shards:
    flat rank ``h * chips_per_host + c``, so shard layouts are the flat
    mesh's."""
    if n_hosts < 1 or chips_per_host < 1:
        raise ValueError(f"make_mesh2d: {n_hosts} x {chips_per_host}")
    return Mesh(n_hosts * chips_per_host, _mesh_device(device),
                (int(n_hosts), int(chips_per_host)))


def is_2d(mesh: Mesh) -> bool:
    return len(mesh.axis_names) == 2


def flat_axes(mesh: Mesh):
    """The axis spec addressing every shard as one flat rank space: the
    axis-name tuple of a 2-D mesh, the single axis name of a flat one."""
    names = tuple(mesh.axis_names)
    return names if len(names) > 1 else names[0]


def host_shape(mesh: Mesh) -> tuple[int, int]:
    """(n_hosts, chips_per_host): a 2-D mesh's axes, (1, n) for a flat
    one."""
    if is_2d(mesh):
        return mesh.hosts
    return (1, mesh.n)


def chips_per_host_of(mesh: Mesh) -> int:
    """Host granularity for shuffle scheduling: a 2-D mesh's chip axis,
    else the installed :data:`HOST_GRANULARITY`, else the shards of one
    process -- all of them, as the JAX package counts its CPU mesh's
    devices of process 0."""
    if is_2d(mesh):
        return mesh.hosts[1]
    if HOST_GRANULARITY is not None:
        return HOST_GRANULARITY
    return max(1, mesh.n)


def shuffle_order(strategy: str, n: int, chips_per_host: int = 4,
                  seed: int = 12345) -> np.ndarray:
    """Visit-order offsets of the exchange rounds: round i of shard ``d``
    touches partner ``(d + order[i]) % n``.

    Mirrors the reference strategies (numa_shuffle.c:55-85):
      NEXT   -- neighbours first: offsets 0, 1, 2, ...,
      RING   -- stride by the chips-per-host count so consecutive rounds
                hit different hosts (numa_shuffle.c:80),
      RANDOM -- a seeded permutation (numa_shuffle.c:29-37,58-59).
    """
    if strategy == NumaStrategy.NEXT:
        return np.arange(n, dtype=np.int32)
    if strategy == NumaStrategy.RING:
        step = max(1, chips_per_host)
        offs = [(i * step + i // max(1, n // step)) % n for i in range(n)]
        # de-duplicate while preserving order; fill any gaps at the end
        seen, order = set(), []
        for o in offs:
            if o not in seen:
                seen.add(o)
                order.append(o)
        for o in range(n):
            if o not in seen:
                order.append(o)
        return np.asarray(order, dtype=np.int32)
    if strategy == NumaStrategy.RANDOM:
        rng = np.random.default_rng(seed)
        return rng.permutation(n).astype(np.int32)
    raise ValueError(f"unknown shuffle strategy {strategy!r}")
