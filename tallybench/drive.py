"""What every drive shares, and the lookup of a drive by name.

A mix (``traffic/<mix>.json``) names its ``drive``: the call pattern a cell
drives through the program's entries. The drive is the module
``drives/<drive>.py``, found by name, so that a later change adds one as a
file. It defines:

* ``draw(mix, cfg, rng)``: the drive's own rings, drawn at set-up from the
  seed's generator after the source sites (``generator.py``); a dict.
* ``Driver(tally, traffic, cfg, probe)``: ``batch()`` runs one batch and
  returns the segments it scored; ``batches`` and ``calls`` count what it
  ran, ``last`` records what the reference needs of the last batch, and
  ``outputs()`` gives the program's outputs of that batch beside its flux.
* ``first(traffic)``: the record ``last`` of a fresh tally's first batch
  (the control replays it without the program).
* ``reference(tab, sites, elem, flux, *, cfg, traffic, last, dtype)``: the
  plain reference's replay of the batch ``last`` into ``flux`` from the
  located sites; its outputs in the shape of ``outputs()``.
* ``compare(prog, ref)``: the drive's compared numbers beside the flux's.
"""
from __future__ import annotations

import contextlib
import importlib.util
from pathlib import Path

import torch


def load(name: str, here: Path):
    """The drive module ``<here>/drives/<name>.py``."""
    path = here / "drives" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no drive {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"tallybench_drive_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def span(on: bool, name: str):
    """The benchmark's own profiler span ``tb:<name>`` (nothing when
    untraced)."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function("tb:" + name)


class Probe:
    """What the traced run collects for the per-layer metrics."""

    def __init__(self):
        self.on = False
        self.walks = []       # dict(lanes, iters, segments, initial)
        self.waits = []       # (host seconds the wrapper waited, walks)
        self.step_ms = []     # host ms of the program's steps, per move


def init_walk(stats: dict | None, lanes: int) -> dict | None:
    """The initial search's walk: every lane ends with one iteration that
    is no crossing."""
    if stats is None:
        return None
    return dict(lanes=lanes, segments=0, initial=True,
                iters=stats["crossings"] + stats["chase_hops"] + lanes)


def region_values(cfg: dict, field: str) -> dict:
    """{region: value} of a material field for the pin regions, from the
    configuration's ``pins`` entry (every region but 0)."""
    pins = cfg["materials"].get("pins")
    if not pins or field not in pins:
        return {}
    return {r: float(pins[field]) for r in range(1, int(cfg["regions"]))}


def region_table(cfg: dict, field: str) -> list:
    """The per-region table of a material field, region 0 to the last."""
    base = float(cfg["materials"][field])
    table = [base] * int(cfg["regions"])
    for r, v in region_values(cfg, field).items():
        table[r] = float(v)
    return table
