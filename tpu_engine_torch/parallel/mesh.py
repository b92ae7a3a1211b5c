"""The tensor-parallel group of one serving process (counterpart of
``tpu_engine/parallel/mesh.py``'s ``tp_mesh`` and ``tp_topology_label``).

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

A device list may name one device several times: the CPU tests run every
rank on ``cpu``, and one card runs every rank on ``cuda:0``. Nothing falls
back to the CPU: without a device list the ranks are CUDA devices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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
