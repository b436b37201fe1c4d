"""Per-phase wall-clock accumulators (TallyTimes parity).

Counterpart of ``pumiumtally_tpu/utils/timing.py``. CUDA work is
asynchronous, so a timed phase that asks for it synchronizes the device
(``torch.cuda.synchronize``) before the clock is read, like the
reference's PUMI_MEASURE_TIME-guarded fence.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time

import torch

_log = logging.getLogger("pumiumtally_tpu_torch")


@dataclasses.dataclass
class TallyTimes:
    initialization_time: float = 0.0
    total_time_to_tally: float = 0.0
    vtk_file_write_time: float = 0.0
    n_moves: int = 0

    def print_times(self) -> None:
        total = (
            self.initialization_time
            + self.total_time_to_tally
            + self.vtk_file_write_time
        )
        rows = [
            ("initialization", self.initialization_time),
            ("tally", self.total_time_to_tally),
        ]
        if self.n_moves:
            rows.append(
                ("tally_per_move", self.total_time_to_tally / self.n_moves)
            )
        rows += [("vtk_write", self.vtk_file_write_time), ("total", total)]
        for phase, seconds in rows:
            _log.info("[TIME] %s: %.6f s", phase, seconds)


class phase_timer(contextlib.AbstractContextManager):
    """Accumulate elapsed wall-clock into ``times.<field>``. Inside the
    block, ``.sync(device)`` asks for the device to be synchronized before
    the clock is read (a no-op for the CPU)."""

    def __init__(self, times: TallyTimes, field: str, enabled: bool):
        self._times, self._field, self._enabled = times, field, enabled
        self._device = None

    def sync(self, device) -> None:
        self._device = torch.device(device)

    def __enter__(self):
        if self._enabled:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._enabled:
            if self._device is not None and self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            setattr(
                self._times,
                self._field,
                getattr(self._times, self._field)
                + (time.perf_counter() - self._start),
            )
        return False
