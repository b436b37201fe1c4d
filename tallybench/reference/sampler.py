"""A frozen copy of the counter-based sampler of the device source.

Each lane's draws for one move are keyed by (seed, move, particle id): the
seed's key is its two 32-bit words ``(seed >> 32, seed & 0xFFFFFFFF)``, the
move key ``fold_in(key, move)``, the lane key ``fold_in(move key, pid)``, and
draw i is the threefry2x32 block (20 rounds) of the lane key at counter
(0, i). float32 takes the high 23 bits of ``b1 ^ b2`` as the mantissa of a
number in [1, 2), float64 the high 52 bits of ``b1·2^32 + b2``; minus 1.
These are JAX's ``threefry2x32``, ``fold_in`` and ``uniform`` bits, which
the program's flight kernel also draws.

Five uniforms a lane and move: ``mu = 2u0 - 1``, ``phi = 2π·u1``, the unit
exponential length ``-log1p(-u2)``, ``u3`` the downscatter draw and ``u4``
the roulette draw. Integers are held in int64 tensors with 32-bit masks.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block of key ``(k0, k1)`` at counter ``(x0, x1)``
    (int64 tensors or ints holding uint32 values)."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def seed_key(seed: int) -> tuple[int, int]:
    s = int(seed) % 2 ** 64
    return s >> 32, s & M32


def fold_in(key, data):
    """The key folded with ``data`` (an int, or an int64 tensor of one
    value per lane)."""
    k0, k1 = key
    if isinstance(data, torch.Tensor):
        return threefry2x32(k0, k1, torch.zeros_like(data),
                            data.to(torch.int64) & M32)
    return threefry2x32(k0, k1, 0, int(data) & M32)


def uniforms(seed: int, move, pid: torch.Tensor, dtype) -> torch.Tensor:
    """``[m, 5]`` uniforms in ``dtype`` (float32 or float64 bits) of the
    lanes ``pid`` (int64) at ``move`` (an int, or an int64 tensor of one
    move a lane)."""
    k0, k1 = fold_in(fold_in(seed_key(seed), move), pid.to(torch.int64))
    ctr = torch.arange(5, device=pid.device)[None, :]
    b1, b2 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(ctr),
                          ctr)
    if dtype == torch.float32:
        bits = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
        return bits.view(torch.float32) - 1.0
    if dtype == torch.float64:
        bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        return bits.view(torch.float64) - 1.0
    raise ValueError(f"uniforms are float32 or float64: {dtype}")


# Mantissa bits dropped when a uniform goes to a narrower float.
_DROP = {(torch.float64, torch.float32): (torch.int64, 52 - 23),
         (torch.float32, torch.bfloat16): (torch.int32, 23 - 7)}


def narrow(u: torch.Tensor, dtype) -> torch.Tensor:
    """``u`` in ``dtype``, cut toward zero where ``dtype`` is narrower, as
    a uniform drawn in that type's mantissa: it stays under 1."""
    key = (u.dtype, dtype)
    if key in _DROP:
        it, bits = _DROP[key]
        u = (u.view(it) & ~((1 << bits) - 1)).view(u.dtype)
    return u.to(dtype)


def draws(u: torch.Tensor, dtype):
    """``(direction [m, 3], ell [m], coll_u [m], roul_u [m])`` in ``dtype``
    from the uniforms ``u``."""
    u = narrow(u, dtype)
    mu = u[:, 0] * 2.0 - 1.0
    phi = u[:, 1] * (2.0 * math.pi)
    s = torch.sqrt(torch.clamp_min(1.0 - mu * mu, 0.0))
    direction = torch.stack([s * torch.cos(phi), s * torch.sin(phi), mu], 1)
    return direction, -torch.log1p(-u[:, 2]), u[:, 3], u[:, 4]
