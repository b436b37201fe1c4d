"""The port's tuning database (``TUNING_TORCH.json``).

Counterpart of ``pumiumtally_tpu/tuning/db.py``. One JSON file holds the
autotuner's winners per shape class (``tuning/shapes.py``), grouped into
environment sections: a decision measured on one card means nothing on the
CPU or on another card, so every section is keyed by the environment it
was measured in, ``{"backend": "cuda" | "cpu", "device": <the card's name
or "cpu">, "n_devices": <cards visible>}``, and a facade refuses a database
that has sections but none for its environment. Its keys start with
``torch-`` (``torch-cuda-d1-NVIDIA-H100-80GB-HBM3``), so they never meet a
JAX section's (``cpu-x64off-d1``); a JAX ``TUNING.json`` given to the port
is refused the same way. A schema other than ``TUNING_SCHEMA`` is refused
too.

Layout::

  {
    "schema": 1,
    "environments": {
      "torch-cpu-d1-cpu": {
        "environment": {"backend": "cpu", "device": "cpu", "n_devices": 1},
        "mode": "rehearsal" | "hardware",
        "entries": {
          "<shape key>": {
            "block": 128,        # the walk kernel's threads per block
            "megastep": 16,      # moves a run_source_moves chunk runs
            "candidates": [... every candidate, parity verdict and
                           median seconds a move included ...],
            "calibration": {"flops_per_s": ..., "bytes_per_s": ..., ...}
          }
        }
      }
    }
  }

A facade consults it once, at construction (``resolve_tuned``): a hit
hands ``TallyConfig.resolve_lane_block`` and ``resolve_megastep`` the
winners; a miss (no entry for the shape class) or no database leaves
today's defaults. Env variables and explicit config fields beat the
database (``utils/config.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import threading

import torch

TUNING_SCHEMA = 1
TUNING_FILE = "TUNING_TORCH.json"


def environment(device=None) -> dict:
    """The environment a decision belongs to, of ``device`` (default: the
    card when one is visible, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"backend": "cuda", "device": torch.cuda.get_device_name(dev),
                "n_devices": torch.cuda.device_count()}
    return {"backend": "cpu", "device": "cpu", "n_devices": 1}


def env_key(env: dict) -> str:
    """Section key, e.g. ``torch-cpu-d1-cpu`` or
    ``torch-cuda-d1-NVIDIA-H100-80GB-HBM3``."""
    name = re.sub(r"[^A-Za-z0-9]+", "-", str(env["device"])).strip("-")
    return f"torch-{env['backend']}-d{env['n_devices']}-{name}"


def empty_db() -> dict:
    return {"schema": TUNING_SCHEMA, "environments": {}}


class TuningDB:
    """A parsed database and the section of one environment."""

    def __init__(self, data: dict, path: str | None = None):
        if not isinstance(data, dict) or "schema" not in data:
            raise ValueError(
                f"tuning database {path or '<dict>'} has no schema "
                "field — not a tuning database"
            )
        if data["schema"] != TUNING_SCHEMA:
            raise ValueError(
                f"tuning database {path or '<dict>'} has schema "
                f"{data['schema']!r}, this build consumes schema "
                f"{TUNING_SCHEMA} — regenerate it with "
                "python -m pumiumtally_tpu_torch.tuning"
            )
        self.data = data
        self.path = path

    @property
    def environments(self) -> dict:
        return self.data.get("environments", {})

    def section(self, env: dict | None = None, *, strict: bool = True):
        """The section of ``env`` (default: ``environment()``).
        ``strict`` raises on a database that has sections but none for
        this environment; an empty database is all-miss, not an error."""
        env = env or environment()
        sec = self.environments.get(env_key(env))
        if sec is not None:
            if sec.get("environment") != env:
                raise ValueError(
                    f"tuning database {self.path or '<dict>'} section "
                    f"{env_key(env)!r} records environment "
                    f"{sec.get('environment')} but the current "
                    f"environment is {env} — the section key and its "
                    "pinned environment drifted; regenerate with "
                    "python -m pumiumtally_tpu_torch.tuning"
                )
            return sec
        if strict and self.environments:
            raise ValueError(
                f"tuning database {self.path or '<dict>'} has no "
                f"section for the current environment {env} "
                f"(sections: {sorted(self.environments)}) — tuning "
                "decisions do not transfer across devices; re-tune "
                "with python -m pumiumtally_tpu_torch.tuning or set "
                "PUMI_TPU_TUNING=off"
            )
        return None

    def lookup(self, shape, env: dict | None = None) -> dict | None:
        """The entry of one shape class (a ``ShapeClass`` or its key), or
        None (a miss)."""
        sec = self.section(env)
        if sec is None:
            return None
        key = shape if isinstance(shape, str) else shape.key()
        return sec.get("entries", {}).get(key)


def load_tuning(path: str) -> TuningDB:
    with open(path) as fh:
        return TuningDB(json.load(fh), path=path)


def write_tuning(path: str, data: dict) -> None:
    """Write the database atomically (a crash mid-write leaves the
    previous file, never a torn one)."""
    from ..utils.checkpoint import atomic_write_json

    atomic_write_json(path, data)


# Facades construct often; the parsed database is cached by (path, mtime),
# so a database rewritten in place is read again.
_cache: dict = {}
_cache_lock = threading.Lock()


def cached_tuning(path: str) -> TuningDB:
    key = (os.path.abspath(path), os.stat(path).st_mtime_ns)
    with _cache_lock:
        db = _cache.get(key)
        if db is None:
            db = load_tuning(path)
            # One generation per path: drop only this path's stale mtimes.
            for stale in [k for k in _cache if k[0] == key[0]]:
                del _cache[stale]
            _cache[key] = db
        return db


@dataclasses.dataclass(frozen=True)
class TunedDecision:
    """What the database said for one workload; None fields mean no
    opinion (the defaults apply)."""

    path: str | None = None  # the database consulted (None: tuning off)
    key: str | None = None   # the shape-class key looked up
    hit: bool = False
    block: int | None = None     # the walk kernel's threads per block
    megastep: int | None = None


TUNING_OFF = TunedDecision()


def resolve_tuned(cfg, *, ntet: int, n_particles: int, n_groups: int,
                  dtype, packed: bool, device=None) -> TunedDecision:
    """A facade's one consult at construction: the path from
    ``cfg.resolve_tuning()`` (None: ``TUNING_OFF``), then
    ``lookup_tuned`` in the environment of ``device``. An unreadable
    database, one of another schema or one without a section for this
    environment raises: naming a file is an explicit request."""
    path = cfg.resolve_tuning()
    if path is None:
        return TUNING_OFF
    return lookup_tuned(path, ntet=ntet, n_particles=n_particles,
                        n_groups=n_groups, dtype=dtype, packed=packed,
                        device=device)


def lookup_tuned(path: str, *, ntet: int, n_particles: int, n_groups: int,
                 dtype, packed: bool, device=None) -> TunedDecision:
    """``resolve_tuned`` with the path already resolved."""
    from .shapes import classify

    db = cached_tuning(path)
    shape = classify(ntet, n_particles, n_groups, dtype, packed)
    entry = db.lookup(shape, environment(device))
    if entry is None:
        return TunedDecision(path=path, key=shape.key(), hit=False)
    block = entry.get("block")
    mega = entry.get("megastep")
    return TunedDecision(
        path=path,
        key=shape.key(),
        hit=True,
        block=int(block) if block else None,
        megastep=int(mega) if mega else None,
    )
