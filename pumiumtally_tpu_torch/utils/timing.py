"""Per-phase wall-clock accumulators (TallyTimes parity).

Counterpart of ``pumiumtally_tpu/utils/timing.py``. CUDA work is
asynchronous, so a timed phase that asks for it synchronizes the device
(``torch.cuda.synchronize``) before the clock is read, like the
reference's PUMI_MEASURE_TIME-guarded fence.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from .log import log_time


@dataclasses.dataclass
class TallyTimes:
    initialization_time: float = 0.0
    total_time_to_tally: float = 0.0
    vtk_file_write_time: float = 0.0
    n_moves: int = 0

    def print_times(self) -> None:
        """One ``[TIME]`` record per phase through ``utils/log.py``."""
        total = (
            self.initialization_time
            + self.total_time_to_tally
            + self.vtk_file_write_time
        )
        log_time("initialization", self.initialization_time)
        log_time("tally", self.total_time_to_tally, n_moves=self.n_moves)
        if self.n_moves:
            log_time(
                "tally_per_move",
                self.total_time_to_tally / self.n_moves,
                n_moves=self.n_moves,
            )
        log_time("vtk_write", self.vtk_file_write_time)
        log_time("total", total)


class StepClock:
    """Times of the named host steps of facade calls, for measurement.

    A facade or pipeline with a clock set (``PumiTally.step_clock``,
    ``StreamingTallyPipeline.step_clock``) wraps each host step of a call
    in ``clock.step(name)``. A step's row holds its host
    clock and, on the card, its stream span: the CUDA events recorded on
    the current stream at the step's entry and exit, so the span runs
    from the stream reaching the work queued before the step to the
    stream finishing the work the step queued (idle time included). No
    step synchronizes; ``rows()`` does, once, to read the events. A step
    is a row per call: ``rows()`` lists them in call order."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._rows: list = []

    @contextlib.contextmanager
    def step(self, name: str):
        cuda = self.device.type == "cuda"
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            host = time.perf_counter() - t0
            if cuda:
                b.record()
            self._rows.append((name, host, (a, b) if cuda else None))

    def note(self, name: str, host_s: float) -> None:
        """A row of a host time measured elsewhere (a wait inside a
        wrapper), with no stream span."""
        self._rows.append((name, host_s, None))

    def rows(self) -> list[dict]:
        """``{"step", "host_ms", "stream_ms"}`` per step in call order
        (``stream_ms`` is None off the card); clears the clock."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = [
            {"step": name, "host_ms": host * 1e3,
             "stream_ms": ev[0].elapsed_time(ev[1]) if ev else None}
            for name, host, ev in self._rows
        ]
        self._rows = []
        return out


def clock_step(clock: StepClock | None, name: str):
    """``clock.step(name)``, or a context that does nothing without a
    clock."""
    return contextlib.nullcontext() if clock is None else clock.step(name)


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
