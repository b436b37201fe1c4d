"""The check that decides ``correct``: the reference replays the batch that
was in progress when the window closed, from the same inputs, and the
program's outputs of that batch are compared with it.

Numbers (a cell compares those its ``limits/<workload>.json`` gives a limit;
the others are printed as readings):

* ``flux_l1`` / ``sq_l1``: Σ|program − reference| over Σ|reference| of the
  batch's flux, over every bin, of the first and the second moment. The
  program's batch flux is its accumulator after the batch less a copy taken
  before it.
* the drive's own (``drives/<drive>.py``, ``compare``).
"""
from __future__ import annotations

import torch

from . import meshgen
from .reference import mesh as ref_mesh
from .reference import transport

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


def flux_numbers(prog: torch.Tensor, ref: torch.Tensor) -> dict:
    """The flux numbers of two flat ``[bins · 2]`` float64 tensors."""
    out = {}
    for name, k in (("flux_l1", 0), ("sq_l1", 1)):
        p, r = prog[k::2], ref[k::2]
        out[name] = float((p - r).abs().sum() / r.abs().sum())
    return out


def rel(a: float, b: float) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1.0)


def reference_batch(cfg, drive, traffic, last, arrays, device,
                    dtype) -> dict:
    """Replay the batch ``last`` (the driver's record) on the reference in
    ``dtype``, on tables it builds from the raw mesh arrays; returns the
    drive's reference outputs and the flux (float64)."""
    coords, tets, class_id = arrays
    tab = ref_mesh.build(coords, tets, class_id, dtype, device)
    flux = torch.zeros(tab.ntet * int(cfg["n_groups"]) * 2, dtype=dtype,
                       device=device)
    sites_np = traffic.sites[last["site"]]
    sites = torch.as_tensor(sites_np, device=device).to(dtype)
    cand = meshgen.candidates(sites_np, cfg["mesh"]["cells"])
    elem = transport.locate_sites(tab, sites, cand)
    out = drive.reference(tab, sites, elem, flux, cfg=cfg, traffic=traffic,
                          last=last, dtype=dtype)
    out["flux"] = flux.double()
    return out


def numbers(drive, prog: dict, ref: dict) -> dict:
    """The compared numbers of a batch: ``prog`` holds the program's
    ``flux`` (flat float64 on the reference's device) and the drive's
    ``outputs()``."""
    return {**flux_numbers(prog["flux"], ref["flux"]),
            **drive.compare(prog, ref)}


def verdict(nums: dict, limits: dict) -> bool:
    """True when every limited number is there and at or under its limit
    (a NaN fails)."""
    return all(k in nums and nums[k] <= limits[k] for k in limits)
