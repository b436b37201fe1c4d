"""Shape-class bucketing of the port's autotuner.

Counterpart of ``pumiumtally_tpu/tuning/shapes.py`` (its own copy). A
tuning decision (the walk kernel's block width, the megastep K) belongs to
a workload's shape, not to one exact particle count: concrete ``(ntet,
n_particles, n_groups, dtype, packed)`` workloads collapse onto a padded
power-of-two ladder in the two large axes and stay exact in the small ones
(``n_groups``, the dtype and whether the mesh carries geo20 each change
which kernel instantiation runs, so they never share a bucket). The keys
are the JAX package's, e.g. ``ntet256.n512.g2.float32.packed``, with the
dtype named from the torch dtype.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Floor of the padded ladder: every workload at or below it shares one
# rung (tiny workloads are all launch-bound).
PAD_FLOOR = 64


def pow2_ceil(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    n = 1
    while n < x:
        n <<= 1
    return n


def bucket(x: int) -> int:
    """Pad one ladder axis: power-of-two ceiling, floored at PAD_FLOOR."""
    return max(PAD_FLOOR, pow2_ceil(max(int(x), 1)))


def dtype_name(dtype) -> str:
    """The canonical name of a float type ("float32", "float64"), from a
    torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


@dataclasses.dataclass(frozen=True)
class ShapeClass:
    """One rung of the padded workload ladder: ``ntet`` and
    ``n_particles`` are the padded values, ``dtype`` the canonical name,
    ``packed`` whether the mesh carries the geo20 walk table."""

    ntet: int
    n_particles: int
    n_groups: int
    dtype: str
    packed: bool

    def key(self) -> str:
        """Stable database key, e.g. ``ntet4096.n8192.g2.float32.packed``."""
        p = "packed" if self.packed else "unpacked"
        return (
            f"ntet{self.ntet}.n{self.n_particles}"
            f".g{self.n_groups}.{self.dtype}.{p}"
        )


def classify(ntet: int, n_particles: int, n_groups: int, dtype,
             packed: bool) -> ShapeClass:
    """Bucket one concrete workload onto the padded ladder."""
    return ShapeClass(
        ntet=bucket(ntet),
        n_particles=bucket(n_particles),
        n_groups=int(n_groups),
        dtype=dtype_name(dtype),
        packed=bool(packed),
    )
