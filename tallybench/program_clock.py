"""The program's own clock of the traced window, summed under its
``run_source_moves`` calls: ``utils/timing.py::last_clock()`` of the
program is the ``StepClock`` the harness sets on the tally for the traced
window, which the facade binds for each call. A program without such a
clock, or a clock of calls off the card, gives nothing."""


def source_totals():
    """``(totals, moves)``: the clock's ``{name: {"count", "host_ns",
    "self_ns"}}`` under ``run_source_moves`` (a host read of a site under
    ``"read:<site>"``) and the fused moves they ran (their ``walk`` rows);
    None where there is nothing to read."""
    from pumiumtally_tpu_torch.utils import timing

    last = getattr(timing, "last_clock", None)
    clock = last() if last is not None else None
    device = getattr(clock, "device", None)
    if device is None or device.type != "cuda":
        return None
    call = clock.totals().get("run_source_moves", {})
    moves = call.get("walk", {}).get("count", 0)
    return (call, moves) if moves else None
