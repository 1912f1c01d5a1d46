"""Work partitioning across processes (counterpart of ``partition_work`` in
``tvc/parallel/mesh.py``; the device mesh itself is item A10 of ROADMAP.md)."""

from __future__ import annotations

from typing import List


def partition_work(items: List, num_shards: int, shard_id: int) -> List:
    """Static round-robin share of the work items (videos, walks) that process
    ``shard_id`` of ``num_shards`` runs."""
    return [it for i, it in enumerate(items) if i % num_shards == shard_id]
