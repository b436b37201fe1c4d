"""The device source of the megastep: flight sampling and the collision
and termination physics (plain PyTorch version).

Counterpart of ``pumiumtally_tpu/ops/source.py``. The megastep
(``ops/walk.py::megastep``) runs the inner loop of
``models/transport.py``'s batch on the card: every fused move re-sources
each alive lane, walks it and applies the physics, so the host sees only
the end of a chunk of moves.

  * **counter-based random numbers keyed by (seed, move, particle id)**,
    the JAX package's own bits: the move key is ``fold_in(key(seed),
    move)`` and each lane draws five uniforms from ``fold_in(move key,
    pid)``, each a threefry2x32 block at counter ``(0, i)``. A lane's
    draws do not depend on its slot or on how the moves are chunked, so
    megastep-K gives the bits of K megastep-1 calls. ``threefry2x32`` is
    written in int64 with 32-bit masks (torch's uint32 ops are partial);
    the uniforms equal ``jax.random.uniform``'s bit for bit in float32
    and float64.
  * **flight sampling** (``sample_move``, plus ``flight_dest``): an
    isotropic direction (mu, phi) and a unit exponential length
    (``-log1p(-u)``) scaled by the lane's region Σt. The card runs it as
    the kernel ``csrc/source.cu`` (``ops/source_cuda.py``); this is its
    plain version. cos, sin and log1p come from the platform's libm, so
    directions and lengths agree with the JAX package's within ulps, not
    bit for bit.
  * **physics** (``apply_physics``): the outcome decode (reached,
    escaped, truncated), survival-weighting absorption, downscatter and
    Russian roulette, as torch ops, with the four sums kept on the
    device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# The physics tail of a megastep, in walk-dtype floats on the readback
# (counts are exact to 2^24 lanes in float32), the JAX package's fields:
#   collisions — lanes that completed their sampled flight (summed over
#     the fused moves);
#   escaped — lanes terminated at the domain boundary;
#   rouletted — lanes killed by Russian roulette;
#   absorbed_weight — Σ weight·absorption over collisions;
#   alive — lanes in flight at the end of the chunk (the host's early
#     stop);
#   truncated — lanes left mid-walk by max_crossings, summed over the
#     fused moves (they stay alive and continue next move).
MEGA_PHYS_FIELDS = (
    "collisions",
    "escaped",
    "rouletted",
    "absorbed_weight",
    "alive",
    "truncated",
)
MEGA_PHYS_LEN = len(MEGA_PHYS_FIELDS)
MEGA_PHYS_IDX = {name: i for i, name in enumerate(MEGA_PHYS_FIELDS)}

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclasses.dataclass(frozen=True)
class SourceParams:
    """Per-region one-speed flight physics of the device source (the
    ``models/transport.py`` Material map as tables).

    Attributes:
      sigma_t: region class id → total macroscopic cross-section [1/cm]
        (regions absent from the map use ``default_sigma_t``).
      absorption: region class id → absorbed fraction per collision.
      survival_weight: weight floor below which Russian roulette fires.
      downscatter: per-collision probability of dropping one energy group
        (multi-group configs only).
      seed: the random stream's seed; the move key is
        ``fold_in(key(seed), move)`` with the facade's move counter.
    """

    sigma_t: dict | None = None
    absorption: dict | None = None
    default_sigma_t: float = 1.0
    default_absorption: float = 0.3
    survival_weight: float = 0.1
    downscatter: float = 0.5
    seed: int = 0

    def tables(self, class_id) -> tuple[np.ndarray, np.ndarray]:
        """Host float64 ``[max_class+1]`` Σt and absorption tables indexed
        by region class id."""
        cid = np.asarray(class_id)
        hi = int(cid.max(initial=0)) + 1
        for d in (self.sigma_t, self.absorption):
            if d:
                hi = max(hi, max(int(k) for k in d) + 1)
        sig = np.full(hi, float(self.default_sigma_t), np.float64)
        ab = np.full(hi, float(self.default_absorption), np.float64)
        for k, v in (self.sigma_t or {}).items():
            sig[int(k)] = float(v)
        for k, v in (self.absorption or {}).items():
            ab[int(k)] = float(v)
        return sig, ab

    def physics_key(self) -> tuple:
        """Hashable identity of the tables and the physics knobs; the seed
        is excluded (a fresh seed per batch re-uploads nothing)."""
        return (
            tuple(sorted((self.sigma_t or {}).items())),
            tuple(sorted((self.absorption or {}).items())),
            self.default_sigma_t,
            self.default_absorption,
            self.survival_weight,
            self.downscatter,
        )

    def cache_key(self) -> tuple:
        """Hashable identity for caches that depend on the seed too."""
        return self.physics_key() + (self.seed,)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def staged_tables(params: SourceParams, class_id, dtype, device, cache=None):
    """The Σt and absorption tables on ``device`` in ``dtype``, staged once
    per physics identity (``physics_key``). ``cache`` is a previous return
    value or None; returns ``(key, sigma_t, absorption)``."""
    key = params.physics_key()
    if cache is not None and cache[0] == key:
        return cache
    sig, ab = params.tables(_host(class_id))
    return (key, torch.as_tensor(sig, dtype=dtype, device=device),
            torch.as_tensor(ab, dtype=dtype, device=device))


def least_sigma_t(params: SourceParams, class_values) -> float:
    """The least Σt over the mesh's regions (``class_values``, its
    distinct class ids): the longest mean flight a lane can draw."""
    cls = _host(class_values)
    table = params.tables(cls)[0]
    return float(table[np.clip(cls, 0, table.size - 1)].min())


def prng_key(seed: int) -> tuple[int, int]:
    """The threefry key of ``seed`` as two uint32 words (host ints), the
    words of ``jax.random.key_data(jax.random.PRNGKey(seed))``: the high
    and low 32 bits of the seed as a 64-bit integer."""
    s = int(seed) % 2**64
    return s >> 32, s & _M32


def staged_rng_key(seed: int, cache=None):
    """The key words of one source seed (``prng_key``), kept per seed:
    ``cache`` is a previous return value or None; returns ``(seed,
    (k0, k1))``. The key stays on the host: the card gets each move's key
    as two kernel arguments, never as a copy."""
    if cache is not None and cache[0] == int(seed):
        return cache
    return int(seed), prng_key(seed)


def near_epsilon(coords) -> float:
    """The reached-destination tolerance: 1e-4 of the bounding box's
    diagonal (``coords`` in the mesh dtype), as the JAX package's."""
    c = _host(coords).astype(np.float64)
    return 1e-4 * float(np.linalg.norm(c.max(axis=0) - c.min(axis=0)))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block (20 rounds) of the JAX package, on int64
    tensors or Python ints holding uint32 values; returns ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(key_words, data):
    """``jax.random.fold_in``: the threefry block of ``key_words`` at
    counter ``(0, data)``, ``data`` taken as uint32 (a Python int, or an
    int tensor for one key per element)."""
    k0, k1 = key_words
    if isinstance(data, torch.Tensor):
        return threefry2x32(k0, k1, torch.zeros_like(data, dtype=torch.int64),
                            data.to(torch.int64) & _M32)
    return threefry2x32(k0, k1, 0, int(data) & _M32)


def uniforms(lane_k0, lane_k1, count: int, dtype) -> torch.Tensor:
    """``jax.random.uniform(lane_key, (count,), dtype)`` for int64
    tensors of lane key words: ``[m, count]`` in ``dtype``, bit for bit.
    Draw i is the threefry block at counter ``(0, i)``; float32 takes the
    high 23 bits of ``b1 ^ b2``, float64 the high 52 of ``b1·2^32 + b2``
    (``(b1 << 20) | (b2 >> 12)``: no int64 overflow), as the mantissa of
    a number in [1, 2), minus 1."""
    zero = torch.zeros_like(lane_k0)
    cols = []
    for i in range(count):
        b1, b2 = threefry2x32(lane_k0, lane_k1, zero, zero + i)
        if dtype == torch.float32:
            bits = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
            cols.append(bits.view(torch.float32) - 1.0)
        elif dtype == torch.float64:
            bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
            cols.append(bits.view(torch.float64) - 1.0)
        else:
            raise ValueError(f"uniforms are float32 or float64, not {dtype}")
    return torch.stack(cols, dim=1)


def lane_uniforms(move_key, pid, n_total: int, dtype) -> torch.Tensor:
    """The five uniforms of each lane for one move: ``[m, 5]`` from the
    lane key ``fold_in(move_key, clip(pid, 0, n_total-1))``."""
    p = pid.to(torch.int64).clamp(0, n_total - 1)
    return uniforms(*fold_in(move_key, p), 5, dtype)


def sample_move(base_key, move: int, pid, n_total: int, dtype):
    """One move's draws, keyed by (seed, move, particle id), operation for
    operation as the JAX package's ``sample_move``. ``base_key`` is the
    seed's key words (``prng_key``); pids are clipped to ``[0,
    n_total-1]`` (an empty slot's -1 draws particle 0's stream). Returns
    ``(direction [m,3], ell [m], coll_u [m], roul_u [m])``, ``ell`` a
    unit exponential length."""
    return draws_from_uniforms(
        lane_uniforms(fold_in(base_key, move), pid, n_total, dtype))


def draws_from_uniforms(u):
    """``sample_move``'s draws from a lane's five uniforms ``u`` [m, 5]:
    an isotropic direction (mu = 2u0 - 1, phi = 2pi u1), the unit
    exponential length ``-log1p(-u2)`` (uniforms lie in [0, 1), so it
    stays finite), and u3, u4 for the collision and roulette draws."""
    mu = u[:, 0] * 2.0 - 1.0
    phi = u[:, 1] * torch.tensor(2.0 * math.pi, dtype=u.dtype)
    s = torch.sqrt(torch.clamp_min(1.0 - mu * mu, 0.0))
    direction = torch.stack([s * torch.cos(phi), s * torch.sin(phi), mu],
                            dim=1)
    ell = -torch.log1p(-u[:, 2])
    return direction, ell, u[:, 3], u[:, 4]


def flight_dest(origin, direction, ell, sig, alive):
    """The sampled destination: ``origin + direction · (ell / max(Σt,
    tiny))`` for alive lanes, ``origin`` for dead ones (the megastep's
    flight, in the kernel's order of operations)."""
    tiny = torch.finfo(origin.dtype).tiny
    flight = direction * (ell / torch.clamp_min(sig, tiny))[:, None]
    return torch.where(alive[:, None], origin + flight, origin)


def lane_sigma(class_id, elem, table):
    """Each lane's value of a per-region table: ``table[clip(class_id[
    clip(elem)])]`` (the region of the lane's parent element)."""
    ntet, nclass = class_id.shape[0], table.shape[0]
    region = class_id[elem.long().clamp(0, ntet - 1)]
    return table[region.long().clamp(0, nclass - 1)]


def sample_flight_plain(move_key, pid, n_total: int, elem, alive, origin,
                        class_id, sigma_t):
    """The plain version of the kernel ``csrc/source.cu``: one move's
    ``(dest [n,3], coll_u [n], roul_u [n])`` for the move key's words
    (``fold_in(base key, move)``)."""
    direction, ell, coll_u, roul_u = draws_from_uniforms(
        lane_uniforms(move_key, pid, n_total, origin.dtype))
    sig = lane_sigma(class_id, elem, sigma_t)
    return flight_dest(origin, direction, ell, sig, alive), coll_u, roul_u


def apply_physics(position, dest, done, mat_out, weight, group, alive,
                  absorb, coll_u, roul_u, *, eps_near: float,
                  survival_weight: float, downscatter: float,
                  n_groups: int):
    """One move's collision and termination physics, as the JAX package's
    ``apply_physics``. ``position``, ``done`` and ``mat_out`` are the
    walk's outputs, ``dest`` the sampled destination, ``absorb`` each
    lane's absorbed fraction (of its final element's region). Lanes the
    walk truncated (``done`` False) see no physics this move.

    Returns ``(weight', group', alive', phys [4])``, phys = (collisions,
    escaped, rouletted, absorbed_weight) in the walk dtype on the device
    (no host read)."""
    dtype = weight.dtype
    d = position - dest
    dist = torch.linalg.vector_norm(d, dim=-1)
    near = dist < eps_near
    finished = alive & done
    reached = finished & (mat_out < 0) & near
    escaped = finished & (mat_out < 0) & ~near
    absorbed = torch.where(reached, weight * absorb, 0.0).sum()
    weight = torch.where(reached, weight * (1.0 - absorb), weight)
    if n_groups > 1:
        down = reached & (coll_u < downscatter)
        group = torch.where(down, torch.clamp_max(group + 1, n_groups - 1),
                            group)
    alive = alive & ~escaped
    low = alive & (weight < survival_weight)
    lucky = low & (roul_u < 0.5)
    weight = torch.where(lucky, weight * 2.0, weight)
    killed = low & ~lucky
    alive = alive & ~killed
    phys = torch.stack([reached.sum().to(dtype), escaped.sum().to(dtype),
                        killed.sum().to(dtype), absorbed.to(dtype)])
    return weight, group.to(torch.int32), alive, phys


def phys_to_dict(vec) -> dict:
    """Named host view of one [MEGA_PHYS_LEN] physics tail vector."""
    v = np.asarray(vec, np.float64)
    if v.shape != (MEGA_PHYS_LEN,):
        raise ValueError(
            f"expected a [{MEGA_PHYS_LEN}] megastep physics vector, "
            f"got {v.shape}"
        )
    out = {f: float(v[i]) for i, f in enumerate(MEGA_PHYS_FIELDS)}
    for f in ("collisions", "escaped", "rouletted", "alive", "truncated"):
        out[f] = int(out[f])
    return out
