"""Profiler integration and device memory statistics.

Counterpart of ``pumiumtally_tpu/utils/profiling.py`` on
``torch.profiler``:

  * ``profile_trace(logdir)`` captures a trace of the block (host spans,
    and the card's kernels where CUDA is available) and writes it into
    ``logdir`` as a Chrome trace (``trace.json``, for Perfetto or
    chrome://tracing);
  * ``annotate(name)`` is a named host span (``record_function``) that
    shows beside the device work in such a trace;
  * ``device_memory_stats`` reads ``torch.cuda.memory_stats``: the caching
    allocator's bytes in use and their peak, and the card's memory, per
    CUDA device. Off the card (no CUDA, or CUDA never initialized in this
    process) there is nothing to report.

Usage::

    with profile_trace("/tmp/tally_trace"):
        with annotate("init"):
            tally.initialize_particle_location(pos)
        with annotate("moves"):
            for _ in range(100):
                tally.move_to_next_location(...)
"""
from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block into
    ``logdir/trace.json`` (the card's activity too when CUDA is
    available); yields ``logdir``."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named host span around device dispatches
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


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
