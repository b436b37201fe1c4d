"""Device memory statistics for the telemetry.

Counterpart of ``device_memory_stats`` in
``pumiumtally_tpu/utils/profiling.py``, on ``torch.cuda.memory_stats``:
the caching allocator's bytes in use and their peak, and the card's
memory, per CUDA device. Off the card (no CUDA, or CUDA never
initialized in this process) there is nothing to report.
"""
from __future__ import annotations

import torch


def device_memory_stats() -> dict:
    """``{"cuda:<i>": {"bytes_in_use", "peak_bytes_in_use",
    "bytes_limit"}}`` for every CUDA device of the process; ``{}`` when
    CUDA is not available or not initialized (reading the stats must not
    create a context on a card the run never used)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i)
                               .total_memory),
        }
    return out
