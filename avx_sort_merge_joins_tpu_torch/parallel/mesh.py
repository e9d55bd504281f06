"""A mesh of N shards, its collectives, and the exchange-scheduling
strategies (counterpart of ``avx_sort_merge_joins_tpu/parallel/mesh.py``;
reference: src/util/cpu_mapping.c and src/util/numa_shuffle.c:55-85).

The JAX package runs its distributed joins on a mesh of devices from one
process (in its tests 8 virtual CPU devices).  The port's mesh has two
layouts, and the distributed modules reach the shards only through it:

* **one device** (``make_mesh(n, device)``): every shard lives on one
  ``torch.device``.  A per-shard value is a stacked ``(n, ...)`` tensor,
  shard ``me``'s row ``me``, and the collectives are device-side copies of
  the stacks.
* **a device a shard** (``make_mesh(n, devices=...)``,
  :func:`mesh_from_mapping_file`): shard ``me`` lives on ``devices[me]``,
  and a per-shard value is a list of ``n`` tensors, ``x[me]`` on
  ``devices[me]``.  It holds even when the list repeats one device, so the
  layout runs on the CPU and on one card.  One process drives every card;
  a piece that crosses cards moves by ``Tensor.copy_(non_blocking=True)``,
  which PyTorch orders after the current streams of both cards (over
  NVLink peer-to-peer where the cards have it).

Either way ``x[me]`` is shard ``me``'s tensor, and the collectives take
and return per-shard values of the mesh's layout:

* ``all_to_all``: shard s's row is cut into as many pieces as the axis has
  members, and piece d lands as piece s of member d (``all_to_all_row``:
  one member's share alone);
* ``all_gather``: every shard's row, concatenated in rank order: one
  tensor on a one-device mesh, a copy on every shard's device otherwise
  (a replicated value: :meth:`Mesh.replicated`, :meth:`Mesh.replica`);
* ``ppermute``: shard ``src``'s row moves to ``dst`` for each pair of a
  permutation, the rounds of the scheduled exchange.

A 2-D ``(host, chip)`` mesh keeps the flat rank ``h * chips_per_host + c``
and addresses either axis alone, as the JAX mesh's axis names do.

Not ported: ``sharding``/``replicated`` (a per-shard value is its own
layout).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..types import NumaStrategy, default_device
from ..utils import profiling

AXIS = "chips"
HOST_AXIS = "host"

# Set by the CLI's --mapping-file (the cpu-mapping.txt analog): when not
# None, make_mesh() and make_mesh2d() without a device take their devices
# from this mesh (cpu_mapping.c:46-80 custom topology vs :178-193 identity
# default).
DEFAULT_MESH: Optional["Mesh"] = None

# Host (NUMA-region) granularity of the flat shard list, the "threads per
# region" that the RING shuffle strides by.  Module state, as in the JAX
# package (mesh.py:31-36): ``make_mesh(chips_per_host=...)`` and a mapping
# file's host count install it for every later mesh of the process.
HOST_GRANULARITY: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n`` shards; ``hosts`` is ``(n_hosts, chips_per_host)`` for a 2-D
    mesh and None for a flat one.  ``devices`` is None for the one-device
    layout (every shard on ``device``) and shard ``me``'s device for the
    device-a-shard layout, whose ``device`` is ``devices[0]``: where
    results that leave the mesh are gathered."""

    n: int
    device: torch.device
    hosts: Optional[tuple[int, int]] = None
    devices: Optional[tuple[torch.device, ...]] = None

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (HOST_AXIS, AXIS) if self.hosts else (AXIS,)

    @property
    def per_shard(self) -> bool:
        """True for the device-a-shard layout (per-shard values are
        lists), False for the one-device layout (stacks)."""
        return self.devices is not None

    def device_of(self, me: int) -> torch.device:
        return self.devices[me] if self.devices else self.device

    @property
    def cards(self) -> list[torch.device]:
        """The distinct devices of the mesh, in shard order."""
        return list(dict.fromkeys(self.devices or (self.device,)))

    # -- per-shard values ------------------------------------------------

    def shard(self, x: torch.Tensor):
        """An ``(n, ...)`` tensor, anywhere, as a per-shard value: row
        ``me`` on shard ``me``'s device."""
        if not self.per_shard:
            return x.to(self.device)
        return [x[me].to(self.devices[me]) for me in range(self.n)]

    def stack(self, rows):
        """Shard ``me``'s tensor ``rows[me]`` for each shard, as a
        per-shard value: one stack, or the rows each on its device."""
        rows = list(rows)
        if not self.per_shard:
            return torch.stack(rows)
        return [r.to(self.devices[me]) for me, r in enumerate(rows)]

    def map(self, fn, *xs):
        """``fn`` of each shard's tensors.  ``fn`` takes tensors with any
        leading dims: a one-device mesh calls it once on the stacks."""
        if not self.per_shard:
            return fn(*xs)
        return [fn(*(x[me] for x in xs)) for me in range(self.n)]

    def full(self, row_shape, fill, dtype=torch.int32):
        """A per-shard value of ``row_shape`` rows filled with ``fill``."""
        if not self.per_shard:
            return torch.full((self.n, *row_shape), fill, dtype=dtype,
                              device=self.device)
        return [torch.full(tuple(row_shape), fill, dtype=dtype, device=d)
                for d in self.devices]

    def empty(self, row_shape, dtype=torch.int32):
        """A per-shard value of ``row_shape`` rows, uninitialised."""
        if not self.per_shard:
            return torch.empty((self.n, *row_shape), dtype=dtype,
                               device=self.device)
        return [torch.empty(tuple(row_shape), dtype=dtype, device=d)
                for d in self.devices]

    def zeros_like(self, x):
        return self.map(torch.zeros_like, x)

    def empty_like(self, x):
        return self.map(torch.empty_like, x)

    def from_host(self, rows, dtype=torch.int32):
        """Host rows (a nested list or an array with one row a shard) as a
        per-shard value, copied to a card through pinned memory, with no
        wait for the card."""
        if not self.per_shard:
            return _to_device(rows, dtype, self.device)
        return [_to_device(rows[me], dtype, d)
                for me, d in enumerate(self.devices)]

    def tolist(self, x) -> list:
        """A per-shard value read to the host, one entry a shard: one read
        of the stack, or one read a shard's device."""
        if not self.per_shard:
            with profiling.sync("tolist"):
                return x.tolist()
        with profiling.sync("tolist", len(x)):
            return [r.tolist() for r in x]

    def replicated(self, fn, x):
        """``fn`` of a replicated value (what ``all_gather`` returns): once
        on a one-device mesh, on every shard's copy otherwise."""
        return fn(x) if not self.per_shard else [fn(r) for r in x]

    def replica(self, x, me: int):
        """Shard ``me``'s copy of a replicated value."""
        return x[me] if self.per_shard else x

    def own_rows(self, x):
        """Row ``me`` of shard ``me``'s copy of a replicated ``(n, ...)``
        value, for each shard: a per-shard value."""
        return [x[me][me] for me in range(self.n)] if self.per_shard else x

    def row_ptrs(self, x) -> list[int]:
        """Each shard's row address (``data_ptr``), for a kernel that takes
        a table of them; a stack's rows by its stride, with no view made a
        row."""
        if self.per_shard:
            return [r.data_ptr() for r in x]
        step = x.stride(0) * x.element_size()
        return [x.data_ptr() + me * step for me in range(self.n)]

    @staticmethod
    def host_sum(values) -> int:
        """The sum of 0-d tensors that may lie on several devices, read to
        the host once a device."""
        by_dev: dict = {}
        for v in values:
            by_dev.setdefault(v.device, []).append(v)
        with profiling.sync("host_sum", len(by_dev)):
            return sum(int(torch.stack(vs).sum()) for vs in by_dev.values())

    def rotated_blocks(self, x, width: int, off: int, group: int = 1):
        """Each shard's block ``(me // group + off) mod B`` of ``width``
        elements (its row cut into B blocks), as a per-shard value of
        ``(width,)`` rows."""
        if not self.per_shard:
            me = torch.arange(self.n, device=x.device)
            x3 = x.reshape(self.n, -1, width)
            return x3[me, (me // group + off) % x3.shape[1]]
        out = []
        for me in range(self.n):
            r = x[me].reshape(-1, width)
            out.append(r[(me // group + off) % r.shape[0]])
        return out

    def put_rotated_blocks(self, out, pieces, width: int, off: int,
                           group: int = 1) -> None:
        """Write each shard's piece into its block ``(me // group + off)
        mod B`` of ``out`` (in place)."""
        if not self.per_shard:
            me = torch.arange(self.n, device=out.device)
            o3 = out.view(self.n, -1, width)
            o3[me, (me // group + off) % o3.shape[1]] = pieces
            return
        for me in range(self.n):
            r = out[me].view(-1, width)
            r[(me // group + off) % r.shape[0]].copy_(pieces[me],
                                                      non_blocking=True)

    def check_rows(self, x, name: str, row: int,
                   dtype=torch.int32) -> None:
        """Raise ``ValueError`` unless ``x`` is a per-shard value of
        contiguous ``(row,)`` rows of ``dtype``, each on its shard's
        device."""
        if self.per_shard:
            ok = isinstance(x, (list, tuple)) and len(x) == self.n and all(
                isinstance(r, torch.Tensor) and r.dtype == dtype
                and tuple(r.shape) == (row,) and r.is_contiguous()
                and r.device == d for r, d in zip(x, self.devices))
            where = f"{self.n} shards, each on its shard's device"
            shape = [row]
        else:
            ok = (isinstance(x, torch.Tensor) and x.dtype == dtype
                  and tuple(x.shape) == (self.n, row) and x.is_contiguous()
                  and x.device == self.device)
            where, shape = str(self.device), [self.n, row]
        if not ok:
            kind = str(dtype).replace("torch.", "")
            raise ValueError(f"{name} must be a contiguous {kind}{shape} on "
                             f"{where}")

    def _check_stack(self, x, name: str) -> None:
        if self.per_shard:
            if not isinstance(x, (list, tuple)) or len(x) != self.n:
                raise ValueError(f"{name}: not a list of the mesh's {self.n} "
                                 "shards")
            for me, r in enumerate(x):
                if r.device != self.devices[me]:
                    raise ValueError(f"{name}: shard {me} on {r.device}, "
                                     f"mesh on {self.devices[me]}")
            return
        if x.dim() < 1 or x.shape[0] != self.n:
            raise ValueError(f"{name}: leading axis {tuple(x.shape)} is not "
                             f"the mesh's {self.n} shards")
        if x.device != self.device:
            raise ValueError(f"{name}: tensor on {x.device}, mesh on "
                             f"{self.device}")

    def _members(self, me: int, axis: Optional[str]) -> tuple[list, int]:
        """The flat ranks of ``me``'s group on ``axis``, in member order,
        and ``me``'s index among them."""
        if not self.hosts or axis is None:
            return list(range(self.n)), me
        H, C = self.hosts
        h, c = divmod(me, C)
        if axis == AXIS:
            return [h * C + j for j in range(C)], c
        return [j * C + c for j in range(H)], h

    # -- collectives -----------------------------------------------------

    def all_to_all(self, x, axis: Optional[str] = None):
        """Tiled all-to-all of a per-shard value of ``(m,)`` rows: shard
        s's row is cut into as many pieces as the axis has members, piece
        d goes to member d, and member d keeps the pieces in source order.
        ``axis=None`` is the whole (flat) mesh; on a 2-D mesh ``AXIS``
        exchanges within each host and ``HOST_AXIS`` across hosts.  The
        result is new contiguous memory, as a collective's receive buffer
        is (with one element a piece, ``reshape`` would return a strided
        view)."""
        self._check_stack(x, "all_to_all")
        if self.per_shard:
            out = []
            for d in range(self.n):
                group, i = self._members(d, axis)
                m = x[d].numel()
                k = m // len(group)
                o = torch.empty(m, dtype=x[d].dtype, device=self.devices[d])
                for j, s in enumerate(group):
                    o[j * k:(j + 1) * k].copy_(
                        x[s].reshape(-1)[i * k:(i + 1) * k],
                        non_blocking=True)
                out.append(o.reshape(x[d].shape))
            return out
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

    def all_to_all_row(self, x, d: int) -> torch.Tensor:
        """What member ``d`` receives from a tiled all-to-all of the
        per-shard ``(m,)`` rows over the whole mesh: ``all_to_all(x)[d]``,
        a new contiguous column on ``d``'s device, built alone.  Taking the
        rows one at a time keeps one receive buffer, not every shard's, on
        the device."""
        self._check_stack(x, "all_to_all_row")
        m = x[0].numel()
        if not self.per_shard:
            return x.reshape(self.n, self.n, m // self.n)[:, d].reshape(m)
        k = m // self.n
        o = torch.empty(m, dtype=x[d].dtype, device=self.devices[d])
        for s in range(self.n):
            o[s * k:(s + 1) * k].copy_(x[s].reshape(-1)[d * k:(d + 1) * k],
                                       non_blocking=True)
        return o

    def all_gather(self, x):
        """Every shard's row concatenated in flat rank order: what each
        shard of an all-gather over the whole mesh receives.  A replicated
        value: one tensor on a one-device mesh, a copy on each shard's
        device otherwise."""
        self._check_stack(x, "all_gather")
        if not self.per_shard:
            return x.reshape(-1)
        parts, out = [r.reshape(-1) for r in x], []
        for d in range(self.n):
            o = torch.empty(sum(p.numel() for p in parts), dtype=x[d].dtype,
                            device=self.devices[d])
            at = 0
            for p in parts:
                o[at:at + p.numel()].copy_(p, non_blocking=True)
                at += p.numel()
            out.append(o)
        return out

    def ppermute(self, x, perm, axis: Optional[str] = None):
        """One collective-permute round: for each ``(src, dst)`` pair of
        axis members, member dst receives member src's row; members that
        receive nothing get zeros.  On a 2-D mesh the pairs name hosts
        (``HOST_AXIS``) or chips within a host (``AXIS``)."""
        self._check_stack(x, "ppermute")
        if self.per_shard:
            out = [torch.zeros_like(r) for r in x]
            H, C = self.hosts or (1, self.n)
            for src, dst in perm:
                if self.hosts and axis == HOST_AXIS:
                    pairs = [(src * C + c, dst * C + c) for c in range(C)]
                elif self.hosts and axis == AXIS:
                    pairs = [(h * C + src, h * C + dst) for h in range(H)]
                else:
                    pairs = [(src, dst)]
                for s, d in pairs:
                    out[d].copy_(x[s], non_blocking=True)
            return out
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


def _to_device(rows, dtype, device) -> torch.Tensor:
    """Host data as a tensor on ``device``: to a card through pinned
    memory, since a copy from pageable memory waits for the card."""
    t = torch.tensor(rows, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _mesh_device(device) -> torch.device:
    """``device``, or the card by default, with its index: tensors made on
    ``"cuda"`` land on ``cuda:<current>``, and the collectives compare the
    two."""
    device = torch.device(device) if device is not None else default_device()
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _devices(n: int, devices, device, what: str):
    """The devices of a device-a-shard mesh of ``n`` shards, or None for a
    one-device mesh: ``devices`` when given, else the installed
    :data:`DEFAULT_MESH`'s when no ``device`` is named.  Their first ``n``;
    fewer than ``n`` raises (the JAX ``make_mesh`` would shrink the mesh
    silently, ``mesh.py:51-52``)."""
    if devices is None and device is None and DEFAULT_MESH is not None:
        devices = DEFAULT_MESH.devices
    if devices is None:
        return None
    devices = [_mesh_device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"{what}: {n} shards, {len(devices)} devices "
                         f"({', '.join(map(str, devices))})")
    return tuple(devices[:n])


def make_mesh(n: int, device=None, chips_per_host: Optional[int] = None,
              devices=None) -> Mesh:
    """Flat mesh of ``n`` shards: on one ``device`` (default: the card, see
    :func:`default_device`), or shard ``me`` on ``devices[me]`` (default,
    when no ``device`` is named: the installed :data:`DEFAULT_MESH`'s
    devices).  Unlike the JAX ``make_mesh``, which takes the first ``n``
    of the devices it finds (``mesh.py:51-52``) and so builds a smaller
    mesh when there are fewer, this mesh always has ``n`` shards: fewer
    devices raise ``ValueError``.  ``chips_per_host`` installs the
    topology's host granularity."""
    global HOST_GRANULARITY
    if n < 1:
        raise ValueError(f"make_mesh: {n} shards")
    devs = _devices(n, devices, device, "make_mesh")
    if chips_per_host is not None:
        HOST_GRANULARITY = chips_per_host
    if devs is not None:
        return Mesh(int(n), devs[0], None, devs)
    return Mesh(int(n), _mesh_device(device))


def make_mesh2d(n_hosts: int, chips_per_host: int, device=None,
                devices=None) -> Mesh:
    """2-D ``(host, chip)`` mesh of ``n_hosts * chips_per_host`` shards:
    flat rank ``h * chips_per_host + c``, so shard layouts are the flat
    mesh's.  ``device`` and ``devices`` as in :func:`make_mesh`."""
    if n_hosts < 1 or chips_per_host < 1:
        raise ValueError(f"make_mesh2d: {n_hosts} x {chips_per_host}")
    n = n_hosts * chips_per_host
    devs = _devices(n, devices, device, "make_mesh2d")
    hosts = (int(n_hosts), int(chips_per_host))
    if devs is not None:
        return Mesh(n, devs[0], hosts, devs)
    return Mesh(n, _mesh_device(device), hosts)


def read_mapping_file(path: str) -> tuple[list[int], Optional[int]]:
    """The device ids and the host count (None without one) of a
    device-mapping file ``NDEV id0 ... id{NDEV-1} [#HOSTS]``.  Raises
    ``ValueError`` on a file that does not read so, or holds fewer than
    NDEV ids."""
    with open(path) as f:
        tokens = f.read().split()
    if not tokens:
        raise ValueError(f"mapping file {path}: empty")
    n = int(tokens[0])
    ids = [int(t) for t in tokens[1:1 + n]]
    if n < 1 or len(ids) < n:
        raise ValueError(f"mapping file {path}: NDEV {n} but {len(ids)} "
                         "device ids")
    return ids, int(tokens[1 + n]) if len(tokens) > 1 + n else None


def mesh_from_mapping_file(path: str, device_type: str = "cuda") -> Mesh:
    """A device-a-shard mesh from a device-mapping file, the analog of the
    reference's optional ``cpu-mapping.txt`` (format ``NDEV id0 id1 ...
    id{NDEV-1} [#HOSTS]``, cpu_mapping.h:24-25, cpu_mapping.c:46-80; JAX
    ``mesh.py:117-136``): shard i runs on device ``ids[i]``, ``cuda:<id>``
    on ``device_type="cuda"`` (an id must be below
    ``torch.cuda.device_count()``) and the CPU for every id on ``"cpu"``.
    The optional trailing host count installs :data:`HOST_GRANULARITY`,
    ``NDEV // #HOSTS``, as the JAX function does.  Fewer ids than NDEV, or
    an id past the card count, raise ``ValueError``."""
    global HOST_GRANULARITY
    ids, hosts = read_mapping_file(path)
    n = len(ids)
    if device_type == "cuda":
        count = torch.cuda.device_count()
        bad = [i for i in ids if not 0 <= i < count]
        if bad:
            raise ValueError(f"mapping file {path}: device ids {bad} past "
                             f"the {count} CUDA devices")
        devices = tuple(torch.device("cuda", i) for i in ids)
    elif device_type == "cpu":
        devices = (torch.device("cpu"),) * n
    else:
        raise ValueError(f"mapping file: device type {device_type!r}, not "
                         "'cuda' or 'cpu'")
    if hosts is not None:
        HOST_GRANULARITY = max(1, n // max(1, hosts))
    return Mesh(n, devices[0], None, devices)


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
