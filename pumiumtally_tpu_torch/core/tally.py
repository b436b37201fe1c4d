"""Flux tally accumulator: allocation, normalization, batch squares and
reaction rates.

Counterpart of ``pumiumtally_tpu/core/tally.py`` for the flat layout.
The accumulator is the flat ``[ntet·G·2]`` tensor of stride-2 pairs
(Σ w·len, and in slot 1 either Σ (w·len)² per segment, ``sd_mode=
"segment"``, or Σ T² of per-move bin totals T, ``sd_mode="batch"``,
folded by ``accumulate_batch_squares``). Normalization and the host
reaction rate run in numpy; ``accumulate_batch_squares`` and
``reaction_rate`` are torch ops on the accumulator's device.
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


def _normalize_flux_impl(flux, volumes, n_particles, n_iterations,
                         sd_mode="segment"):
    """(mean flux, second moment, sd) per bin, ``[ntet, n_groups, 3]``.

    Slot 0 = Σc/(vol·N), slot 1 = Σc²/(vol²·N). ``sd_mode="segment"``
    treats the per-segment squares as H = N·M per-(particle, move)
    samples y: s²_y = (Σc² − (Σc)²/H)/(H − 1), sd = sqrt(M·s²_y/N)/vol.
    ``sd_mode="batch"`` reads slot 1 as Σ T² of the M per-move bin totals
    T: s²_T = (ΣT² − (ΣT)²/M)/(M − 1), sd = sqrt(M·s²_T)/(vol·N)."""
    vol = volumes[:, None]
    n = np.asarray(n_particles, flux.dtype)
    m = np.maximum(np.asarray(n_iterations, flux.dtype), 1.0)
    m1 = flux[..., 0] / (vol * n)
    m2 = flux[..., 1] / (vol * vol * n)
    if sd_mode == "segment":
        h = n * m
        var_y = np.maximum(
            flux[..., 1] - flux[..., 0] * flux[..., 0] / h, 0.0
        ) / np.maximum(h - 1.0, 1.0)
        sd = np.sqrt(m * var_y / n) / vol
    elif sd_mode == "batch":
        var_t = np.maximum(
            flux[..., 1] - flux[..., 0] * flux[..., 0] / m, 0.0
        ) / np.maximum(m - 1.0, 1.0)
        sd = np.sqrt(m * var_t) / (vol * n)
    else:
        raise ValueError(
            f"sd_mode must be 'segment' or 'batch': {sd_mode!r}"
        )
    return np.stack([m1, m2, sd], axis=-1)


def normalize_flux_host(flux, volumes, n_particles, n_iterations=1,
                        sd_mode="segment"):
    """Normalize a host ``[ntet, n_groups, 2]`` raw flux by element volume
    and particle count (numpy in, numpy out)."""
    return _normalize_flux_impl(
        np.asarray(flux), np.asarray(volumes), n_particles, n_iterations,
        sd_mode,
    )


def accumulate_batch_squares(flux: torch.Tensor, prev_even: torch.Tensor):
    """Fold one move's squared bin total into the tally, in place
    (``sd_mode="batch"``).

    ``flux`` is the flat stride-2 accumulator whose even entries hold Σc
    including the move just walked (walked with ``score_squares=False``,
    so the walk wrote even entries only); ``prev_even`` is the even-entry
    snapshot from before it. Adds the squared per-bin delta (this move's
    bin total T) to the odd entries and copies the even entries into
    ``prev_even``. Returns ``(flux, prev_even)``, both updated in place:
    two elementwise passes over the accumulator a move."""
    even = flux[0::2]
    delta = even - prev_even
    flux[1::2] += delta * delta
    prev_even.copy_(even)
    return flux, prev_even


def reaction_rate(flux: torch.Tensor, class_id: torch.Tensor,
                  sigma: torch.Tensor) -> torch.Tensor:
    """Track-length reaction-rate tally derived from the flux accumulator.

    A reaction rate Σᵢ wᵢ·lᵢ·σ(eᵢ, gᵢ) is σ(e, g)·Σᵢ wᵢ·lᵢ, because the
    response depends only on the element's material region and the energy
    group: every response tally is a product of the one flux accumulator.

    Args:
      flux: [ntet, n_groups, 2] raw accumulator (Σ w·l, Σ (w·l)²).
      class_id: [ntet] material region per element.
      sigma: [n_regions, n_groups] response coefficient per region and
        group. Region ids outside [0, n_regions) contribute 0.

    Returns [ntet, n_groups, 2]: (Σ w·l·σ, Σ (w·l)²·σ²).
    """
    valid = (class_id >= 0) & (class_id < sigma.shape[0])
    s = torch.where(
        valid[:, None], sigma[class_id.clamp(0, sigma.shape[0] - 1).long()],
        torch.zeros((), dtype=sigma.dtype, device=sigma.device),
    ).to(flux.dtype)
    return torch.stack([flux[..., 0] * s, flux[..., 1] * s * s], dim=-1)


def reaction_rate_host(flux, class_id, sigma) -> np.ndarray:
    """``reaction_rate`` on host numpy arrays, the same arithmetic."""
    flux, class_id, sigma = (np.asarray(flux), np.asarray(class_id),
                             np.asarray(sigma))
    valid = (class_id >= 0) & (class_id < sigma.shape[0])
    s = np.where(
        valid[:, None], sigma[np.clip(class_id, 0, sigma.shape[0] - 1)], 0.0
    ).astype(flux.dtype)
    return np.stack([flux[..., 0] * s, flux[..., 1] * s * s], axis=-1)
