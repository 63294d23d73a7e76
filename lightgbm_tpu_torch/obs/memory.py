"""Device memory snapshots at a configurable cadence.

The port's copy of the JAX package's ``obs/memory.py``, with its field
names: ``bytes_in_use`` and ``peak_bytes_in_use`` from PyTorch's caching
allocator (``torch.cuda.memory_stats``: the bytes its tensors hold, not
the pools it keeps), ``bytes_limit`` the card's memory
(``torch.cuda.get_device_properties``).  Without an initialised CUDA
context the snapshot is one CPU row carrying only the device identity, as
the JAX package's CPU backend gives, so the schema stays the same.
"""
from __future__ import annotations

import torch


def device_memory_stats():
    """One snapshot row a CUDA device (the CPU row without a card)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return [{"id": 0, "platform": "cpu"}]
    rows = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        rows.append({
            "id": i, "platform": "gpu",
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i)
                               .total_memory),
            "num_allocs": int(stats.get("allocation.all.current", 0))})
    return rows


class MemorySampler:
    """Yields a snapshot every ``every`` iterations (0 disables)."""

    def __init__(self, every):
        self.every = int(every)

    def maybe(self, it):
        if self.every > 0 and it % self.every == 0:
            return device_memory_stats()
        return None
