"""Device meshes of the port (counterpart of ``tpu_engine/parallel/mesh.py``):
the tensor-parallel group of one serving process, and the named-axis mesh
of mesh-sharded serving and training.

JAX serves tensor parallelism as one controller over a 1-axis ``model``
mesh: one scheduler drives every device, and XLA inserts the collectives.
The port keeps that shape without ``torch.distributed``: one scheduler,
one rank per entry of a device list, and the two reductions a sharded
forward needs made explicit here:

- ``reduce_sum``: row-parallel partial products summed in rank order, in
  f32, on the first rank's device. Every rank reads that one tensor, so
  the replicated residual stream holds the same bits on every rank.
- ``gather_last``: vocab- (or expert-) sharded outputs concatenated along
  the last axis in rank order.

``Mesh`` is the counterpart of the ``jax.sharding.Mesh`` that
``create_mesh`` builds: named axes (``data``, ``model``) over a grid of
ranks, rank r on ``devices[r]``, ranks in row-major order over the axes as
given. A ``Sharding`` places a tensor on it (one dim split over one axis,
or replicated: JAX's ``NamedSharding`` for the specs the engine and the
train command use), ``place`` cuts a parameter tree into the ranks' trees
(a ``MeshTree``, what ``jax.device_put(tree, shardings)`` gives), and the
mesh's collectives are explicit and in rank order: a gather along a
sharded dim, a scatter and gather of a batch over ``data``, and an f32 sum
of per-rank gradients over ``data``.

A device list may name one device several times: the CPU tests run every
rank on ``cpu``, and one card runs every rank on ``cuda:0``. Nothing falls
back to the CPU: without a device list the ranks are CUDA devices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch


def tp_topology_label(tp: int) -> dict:
    """The mesh-shape label a tensor-parallel lane advertises (worker
    /health, scheduler stats, the gateway's local-lane discovery) and the
    gateway's topology-aware ring parses: the JAX package's schema, which
    is the wire's."""
    return {"tp": int(tp), "mesh_shape": {"model": int(tp)},
            "devices": int(tp)}


def tp_devices(tp: int, devices: Optional[Sequence] = None,
               offset: Optional[int] = None) -> List[torch.device]:
    """The ``tp`` ranks' devices: ``devices[:tp]`` (entries may repeat;
    default every CUDA device), or with ``offset`` (a worker's lane slice)
    CUDA devices ``offset .. offset + tp - 1``. Too few devices refuse with
    the JAX package's messages (its ``tp_mesh``'s, its worker's)."""
    tp = int(tp)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if offset is None:
        devices = [torch.device(d) for d in (
            devices if devices is not None
            else [f"cuda:{i}" for i in range(n)])]
        if tp > len(devices):
            raise ValueError(f"tp={tp} needs {tp} devices, have "
                             f"{len(devices)}")
        return devices[:tp]
    off = int(offset)
    if off < 0 or off + tp > n:
        raise RuntimeError(
            f"--tp {tp} at device offset {off} needs devices "
            f"[{off}, {off + tp}) but only {n} local device(s) exist")
    return [torch.device("cuda", i) for i in range(off, off + tp)]


class TPGroup:
    """``size`` ranks, rank r on ``devices[r]``; rank 0's device is the
    ``home`` of every replicated tensor (the residual stream, logits,
    sampling state)."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a tensor-parallel group needs >= 1 device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def to_rank(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """``x`` on rank ``rank``'s device (the same tensor when it is
        there already)."""
        return x.to(self.devices[rank])

    def reduce_sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of the ranks' partials in rank order, in f32, on
        ``home``."""
        out = parts[0].to(self.home, torch.float32)
        for p in parts[1:]:
            out = out + p.to(self.home, torch.float32)
        return out

    def gather_last(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The ranks' slices concatenated along the last axis in rank
        order, on ``home``."""
        return torch.cat([p.to(self.home) for p in parts], dim=-1)


# -- the named-axis mesh ------------------------------------------------------

class Mesh:
    """Named axes over ``len(devices)`` ranks: rank r on ``devices[r]``,
    its coordinates r unravelled row-major over ``shape`` (JAX's
    ``np.array(devices).reshape(shape)``). ``shape`` maps each axis name
    to its size in the order given, as JAX's ``mesh.shape``."""

    def __init__(self, devices: Sequence, shape: Sequence[int],
                 axis_names: Sequence[str]):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        if len(self.shape) != len(self.axis_names) or len(shape) != len(
                self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} do not match "
                             f"shape {tuple(shape)}")
        if math.prod(self.shape.values()) != len(self.devices):
            raise ValueError(f"mesh shape {tuple(shape)} needs "
                             f"{math.prod(self.shape.values())} devices, "
                             f"have {len(self.devices)}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """Rank 0's device: where gathered batches and losses land."""
        return self.devices[0]

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s index along each axis."""
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def rank(self, **coords: int) -> int:
        """The rank at ``coords`` (axes not named at 0)."""
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + int(coords.get(name, 0))
        return r

    def data_ranks(self, axis: str = "data") -> List[int]:
        """The rank that runs each slice of a batch split over ``axis``:
        the one at that index of ``axis`` and 0 on every other axis."""
        return [self.rank(**{axis: i}) for i in range(self.shape[axis])]

    # -- collectives, in rank order -----------------------------------------

    def scatter_batch(self, x: torch.Tensor,
                      axis: str = "data") -> List[torch.Tensor]:
        """``x``'s rows in ``mesh.shape[axis]`` equal contiguous slices,
        slice i on the device of ``data_ranks(axis)[i]`` (copied without
        blocking the host)."""
        n = self.shape[axis]
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"over {axis}={n}")
        b = x.shape[0] // n
        return [x[i * b:(i + 1) * b].to(self.devices[r], non_blocking=True)
                for i, r in enumerate(self.data_ranks(axis))]

    def gather_batch(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The slices of a batch concatenated in order on ``home``."""
        return torch.cat([p.to(self.home) for p in parts], dim=0)

    @staticmethod
    def gather(parts: Sequence[torch.Tensor], dim: int,
               device) -> torch.Tensor:
        """The shards of one tensor concatenated along ``dim`` in rank
        order, on ``device``."""
        return torch.cat([p.to(device) for p in parts], dim=dim)

    @staticmethod
    def sum_f32(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
        """The sum of per-rank tensors in rank order, in f32, on
        ``device``."""
        out = parts[0].to(device, torch.float32)
        for p in parts[1:]:
            out = out + p.to(device, torch.float32)
        return out


def create_mesh(shape: Optional[Tuple[int, ...]] = None,
                axis_names: Sequence[str] = ("data",),
                devices: Optional[Sequence] = None) -> Mesh:
    """A ``Mesh`` over ``devices`` (default: every CUDA device). ``shape``
    defaults to every device on the first axis; the axis sizes must
    multiply to the device count (the JAX function's message)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    return Mesh(devices, shape, axis_names)


def single_device_mesh(device=None) -> Mesh:
    """A one-rank ``data`` mesh on ``device`` (default the first card)."""
    return create_mesh(shape=(1,), devices=[device or "cuda:0"])


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on ``mesh``: dim ``dim`` split over ``axis`` in
    equal contiguous chunks (rank r holds chunk ``coords(r)[axis]``), or
    whole on every rank (``axis`` None). JAX's ``NamedSharding`` for a
    spec that names one axis, or none."""
    mesh: Mesh
    axis: Optional[str] = None
    dim: Optional[int] = None

    def shard(self, rank: int) -> Optional[int]:
        """The chunk rank ``rank`` holds (None: the whole tensor)."""
        return (None if self.axis is None
                else self.mesh.coords(rank)[self.axis])


def data_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """A batch's leading dim split over ``axis``, the rest whole."""
    return Sharding(mesh, axis, 0)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh)


def flatten_tree(tree) -> list:
    """A tree's leaves: dicts in insertion order, lists in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in flatten_tree(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in flatten_tree(v)]
    return [tree]


def unflatten_tree(template, leaves):
    """``template``'s structure over ``leaves`` (``_flatten``'s order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)
    return build(template)


def _memory_format(t: torch.Tensor):
    """A conv kernel's channels_last layout, kept through a cut and a
    gather (a conv's result may depend on its kernel's layout)."""
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class MeshTree:
    """A parameter tree placed on a mesh: rank r's tree holds each leaf's
    chunk (or the whole leaf) on ``mesh.devices[r]``. Ranks on one device
    that hold the same chunk share one tensor, and a whole leaf already on
    a rank's device is that leaf, not a copy."""

    def __init__(self, mesh: Mesh, template, shardings: List[Sharding],
                 ranks: List[list]):
        self.mesh = mesh
        self._template = template
        self.shardings = shardings   # one per leaf, _flatten's order
        self.ranks = ranks           # rank -> that rank's leaves

    def with_ranks(self, ranks: List[list]) -> "MeshTree":
        """The same placement over other per-rank leaves (an optimizer's
        moments, say)."""
        return MeshTree(self.mesh, self._template, self.shardings, ranks)

    def local(self, rank: int):
        """Rank ``rank``'s tree."""
        return unflatten_tree(self._template, self.ranks[rank])

    def _group(self, rank: int, i: int) -> List[int]:
        """The ranks whose chunks of leaf ``i`` make the whole leaf for
        ``rank``: ``rank``'s coordinates along every axis but the leaf's
        sharded one."""
        s = self.shardings[i]
        at = self.mesh.coords(rank)
        return [self.mesh.rank(**{**at, s.axis: k})
                for k in range(self.mesh.shape[s.axis])]

    def gathered(self, rank: int, ranks: Optional[List[list]] = None):
        """The whole tree on rank ``rank``'s device: every sharded leaf
        gathered from its chunks in rank order (in the leaf's memory
        layout), every whole leaf the rank's own. ``ranks``: per-rank
        leaves to read instead of the placed ones (training's aliases)."""
        ranks = self.ranks if ranks is None else ranks
        dev = self.mesh.devices[rank]
        out = []
        for i, s in enumerate(self.shardings):
            own = ranks[rank][i]
            if s.axis is None:
                out.append(own)
                continue
            whole = self.mesh.gather([ranks[r][i] for r in
                                      self._group(rank, i)], s.dim, dev)
            out.append(whole.contiguous(memory_format=_memory_format(own)))
        return unflatten_tree(self._template, out)

    def owner(self, rank: int, i: int) -> int:
        """The rank that owns the copy of leaf ``i`` that ``rank`` holds:
        the one at ``rank``'s chunk index and 0 on every other axis
        (rank 0 for a whole leaf)."""
        s = self.shardings[i]
        if s.axis is None:
            return 0
        return self.mesh.rank(**{s.axis: self.mesh.coords(rank)[s.axis]})

    def owned(self) -> List[Tuple[int, int]]:
        """(leaf index, owner rank) of every distinct shard, leaves in
        order, owners in rank order."""
        return [(i, r) for i in range(len(self.shardings))
                for r in range(self.mesh.size) if self.owner(r, i) == r]

    def sync(self) -> None:
        """Copy each owner's values into every other rank's copy of its
        shard (after an optimizer step on the owners)."""
        with torch.no_grad():
            for r, leaves in enumerate(self.ranks):
                for i, t in enumerate(leaves):
                    src = self.ranks[self.owner(r, i)][i]
                    if t is not src:
                        t.copy_(src)


def place(tree, shardings) -> MeshTree:
    """``tree`` placed on a mesh (JAX's ``jax.device_put(tree,
    shardings)``): ``shardings`` is one ``Sharding`` for every leaf or a
    tree of them with ``tree``'s structure. Rank r's leaf is the chunk
    ``shardings.shard(r)`` of its dim, or the whole leaf, on
    ``mesh.devices[r]``; gradients are not carried (leaves detached)."""
    leaves = flatten_tree(tree)
    flat_s = ([shardings] * len(leaves) if isinstance(shardings, Sharding)
              else flatten_tree(shardings))
    if len(flat_s) != len(leaves):
        raise ValueError(f"{len(flat_s)} shardings for {len(leaves)} "
                         f"leaves")
    mesh = (shardings.mesh if isinstance(shardings, Sharding)
            else flat_s[0].mesh)
    cut: Dict[tuple, torch.Tensor] = {}
    ranks = []
    for r, dev in enumerate(mesh.devices):
        own = []
        for i, (leaf, s) in enumerate(zip(leaves, flat_s)):
            k = s.shard(r)
            key = (i, k, dev)
            if key not in cut:
                t = leaf.detach()
                if k is not None:
                    n = mesh.shape[s.axis]
                    if t.shape[s.dim] % n:
                        raise ValueError(
                            f"dim {s.dim} of a {tuple(t.shape)} leaf does "
                            f"not split over {s.axis}={n}")
                    fmt = _memory_format(t)
                    t = t.chunk(n, s.dim)[k].to(dev).contiguous(
                        memory_format=fmt)
                else:
                    t = t.to(dev)
                cut[key] = t
            own.append(cut[key])
        ranks.append(own)
    # The structure alone: the tree's own tensors are not kept alive.
    template = unflatten_tree(tree, [None] * len(leaves))
    return MeshTree(mesh, template, flat_s, ranks)
