"""Flux tally accumulator: allocation and normalization.

Counterpart of ``pumiumtally_tpu/core/tally.py`` for the flat layout and
``sd_mode="segment"``. The accumulator is the flat ``[ntet·G·2]`` tensor
of stride-2 pairs (Σ w·len, Σ (w·len)²); normalization runs on the host
in numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.platform import resolve_device


def make_flux(
    ntet: int, n_groups: int, dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """Zero flat tally accumulator ``[ntet * n_groups * 2]`` on ``device``
    (default the CUDA card; ``utils/platform.py::resolve_device``)."""
    return torch.zeros(ntet * n_groups * 2, dtype=dtype,
                       device=resolve_device(device))


def _normalize_flux_impl(flux, volumes, n_particles, n_iterations):
    """(mean flux, second moment, sd) per bin, ``[ntet, n_groups, 3]``.

    Slot 0 = Σc/(vol·N), slot 1 = Σc²/(vol²·N). The sd treats the
    per-segment squares as H = N·M per-(particle, move) samples y:
    s²_y = (Σc² − (Σc)²/H)/(H − 1), sd = sqrt(M·s²_y/N)/vol."""
    vol = volumes[:, None]
    n = np.asarray(n_particles, flux.dtype)
    m = np.maximum(np.asarray(n_iterations, flux.dtype), 1.0)
    m1 = flux[..., 0] / (vol * n)
    m2 = flux[..., 1] / (vol * vol * n)
    h = n * m
    var_y = np.maximum(
        flux[..., 1] - flux[..., 0] * flux[..., 0] / h, 0.0
    ) / np.maximum(h - 1.0, 1.0)
    sd = np.sqrt(m * var_y / n) / vol
    return np.stack([m1, m2, sd], axis=-1)


def normalize_flux_host(flux, volumes, n_particles, n_iterations=1):
    """Normalize a host ``[ntet, n_groups, 2]`` raw flux by element volume
    and particle count (numpy in, numpy out)."""
    return _normalize_flux_impl(
        np.asarray(flux), np.asarray(volumes), n_particles, n_iterations
    )
