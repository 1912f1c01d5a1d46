"""Frame-exchange collectives over ``torch.distributed`` (counterpart of
``tvc/parallel/collectives.py``).

Each process of the default group holds its block of frames (the leading
axis is the data axis):

- ``all_gather_frames``: every process gets every block, in rank order;
- ``broadcast_from``: every process gets the block of rank ``src``;
- ``ring_exchange``: rank i gets the block of rank i - ``shift`` (mod n).

Without a process group each returns its input's block (a group of one).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tvc_torch.parallel.mesh import world


def all_gather_frames(frames: torch.Tensor) -> torch.Tensor:
    """(B_local, ...) on each process -> (B_global, ...) on every process."""
    n, _ = world()
    if n == 1:
        return frames.clone()
    parts = [torch.empty_like(frames) for _ in range(n)]
    dist.all_gather(parts, frames.contiguous())
    return torch.cat(parts, dim=0)


def broadcast_from(frames: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s block, on every process."""
    out = frames.contiguous().clone()
    if world()[0] > 1:
        dist.broadcast(out, src)
    return out


def ring_exchange(frames: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """The block of rank (rank - shift) mod n, on each rank."""
    n, rank = world()
    if shift % n == 0:
        return frames.clone()
    send = frames.contiguous()
    out = torch.empty_like(send)
    reqs = [dist.isend(send, (rank + shift) % n), dist.irecv(out, (rank - shift) % n)]
    for r in reqs:
        r.wait()
    return out
