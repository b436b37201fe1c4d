"""The port's device source (``pumiumtally_tpu_torch/ops/source.py`` and
the CPU path of ``ops/source_cuda.py``) against the JAX package's
``pumiumtally_tpu/ops/source.py``, on the CPU.

* The random numbers bit for bit: the five uniforms of a lane for
  several seeds (one past 2^31 and one past 2^32), moves and particle
  ids (-1 and n_total - 1 included), in float32 and float64, and the
  seed's key words against ``jax.random.key_data``.
* ``sample_move``: the uniforms bitwise, the direction within 2 ulp and
  the length within 3e-14 relative (float64) or 4 ulp (float32): cos,
  sin and log1p come from two libms.
* ``apply_physics`` on crafted lanes of every outcome: the flags and
  groups equal, the weights within 1 ulp, the four sums within rtol
  1e-12 (float64).
* ``SourceParams`` tables and keys, ``phys_to_dict``, ``near_epsilon``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pumiumtally_tpu.ops import source as jsource
from pumiumtally_tpu_torch.ops import source, source_cuda

JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
NPDT = {torch.float32: np.float32, torch.float64: np.float64}
DTYPES = [torch.float32, torch.float64]
SEEDS = [0, 13, 2**31 + 5, 2**33 + 7]
N_TOTAL = 64
PIDS = np.array([-1, 0, 5, 31, N_TOTAL - 1, N_TOTAL + 9], np.int32)


def _jax_uniforms(seed, move, pids, dtype):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), move)
    keys = jax.vmap(lambda q: jax.random.fold_in(key, q))(
        jnp.clip(jnp.asarray(pids), 0, N_TOTAL - 1))
    return np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (5,), JDT[dtype]))(keys))


def _ulps(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want) / np.spacing(np.abs(want).astype(
        want.dtype) + np.finfo(want.dtype).tiny))


def test_threefry_partitionable_is_the_jax_default():
    """The port reproduces the partitionable threefry stream; if JAX's
    default flips, this fails loudly instead of the draws drifting."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_key_words_equal_jax_key_data(seed):
    want = tuple(int(w) for w in np.asarray(
        jax.random.key_data(jax.random.PRNGKey(seed))))
    assert source.prng_key(seed) == want
    assert source.staged_rng_key(seed) == (seed, want)
    cache = source.staged_rng_key(seed)
    assert source.staged_rng_key(seed, cache) is cache


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniforms_bitwise(seed, dtype):
    for move in (0, 3, 1000):
        want = _jax_uniforms(seed, move, PIDS, dtype)
        got = source.lane_uniforms(
            source.fold_in(source.prng_key(seed), move),
            torch.from_numpy(PIDS), N_TOTAL, dtype).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
        # The move key folds the move in as uint32, and the wrapper's
        # debug output carries the same draws.
        u = torch.empty(len(PIDS), 5, dtype=dtype)
        n = len(PIDS)
        source_cuda.sample_flight(
            source.fold_in(source.prng_key(seed), move),
            torch.from_numpy(PIDS), N_TOTAL, torch.zeros(n, dtype=torch.int32),
            torch.ones(n, dtype=torch.bool), torch.zeros(n, 3, dtype=dtype),
            torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=dtype),
            u_out=u)
        np.testing.assert_array_equal(u.numpy().view(np.uint8),
                                      want.view(np.uint8))


def test_threefry_known_answer():
    """Random123's known answer for threefry2x32 with 20 rounds (zero key
    and counter)."""
    assert source.threefry2x32(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sample_move_against_jax(dtype):
    n = 4096
    pid = np.arange(-1, n - 1, dtype=np.int32)
    jout = jsource.sample_move(jax.random.PRNGKey(13), 7, jnp.asarray(pid),
                               n, JDT[dtype])
    tout = source.sample_move(source.prng_key(13), 7, torch.from_numpy(pid),
                              n, dtype)
    jdir, jell, jcu, jru = (np.asarray(a) for a in jout)
    tdir, tell, tcu, tru = (t.numpy() for t in tout)
    np.testing.assert_array_equal(tcu, jcu)
    np.testing.assert_array_equal(tru, jru)
    # Within ulps of the larger component's scale (a direction component
    # near zero is a rounded difference of cos/sin of a large argument).
    assert np.max(np.abs(tdir - jdir)
                  / np.spacing(np.ones((), NPDT[dtype]))) <= 2
    if dtype == torch.float64:
        np.testing.assert_allclose(tell, jell, rtol=3e-14, atol=0)
    else:
        assert _ulps(tell, jell) <= 4


@pytest.mark.parametrize("dtype", DTYPES)
def test_flight_plain_against_jax_formula(dtype):
    """The kernel's plain version (``sample_flight_plain``) against the
    JAX megastep's flight on the JAX draws fed in: dest bitwise for
    dead lanes, within the draws' ulps for alive ones; the collision and
    roulette draws bitwise."""
    rng = np.random.default_rng(0)
    n, ntet = 512, 40
    cls = rng.integers(0, 3, ntet).astype(np.int32)
    sig = np.array([2.0, 5.0, 0.0])  # region 2: Σt 0 meets the tiny floor
    elem = rng.integers(-1, ntet + 1, n).astype(np.int32)
    alive = rng.uniform(size=n) < 0.8
    origin = rng.uniform(0, 1, (n, 3)).astype(NPDT[dtype])
    pid = np.arange(n, dtype=np.int32)
    jkey = jax.random.PRNGKey(5)
    d, ell, cu, ru = jsource.sample_move(jkey, 2, jnp.asarray(pid), n,
                                         JDT[dtype])
    jsig = jnp.asarray(sig, JDT[dtype])[jnp.clip(
        jnp.asarray(cls)[jnp.clip(jnp.asarray(elem), 0, ntet - 1)], 0, 2)]
    tiny = np.finfo(NPDT[dtype]).tiny
    flight = d * (ell / jnp.maximum(jsig, tiny))[:, None]
    want = np.asarray(jnp.where(jnp.asarray(alive)[:, None],
                                jnp.asarray(origin) + flight, origin))
    t = dict(pid=torch.from_numpy(pid), elem=torch.from_numpy(elem),
             alive=torch.from_numpy(alive), origin=torch.from_numpy(origin),
             class_id=torch.from_numpy(cls),
             sigma_t=torch.as_tensor(sig, dtype=dtype))
    mk = source.fold_in(source.prng_key(5), 2)
    dest, coll_u, roul_u = source_cuda.sample_flight(mk, t["pid"], n,
                                                     t["elem"], t["alive"],
                                                     t["origin"],
                                                     t["class_id"],
                                                     t["sigma_t"])
    np.testing.assert_array_equal(coll_u.numpy(), np.asarray(cu))
    np.testing.assert_array_equal(roul_u.numpy(), np.asarray(ru))
    np.testing.assert_array_equal(dest.numpy()[~alive], origin[~alive])
    finite = np.isfinite(want).all(axis=1) & alive & (
        cls[np.clip(elem, 0, ntet - 1)] != 2)
    rtol = 1e-13 if dtype == torch.float64 else 4e-6
    np.testing.assert_allclose(dest.numpy()[finite], want[finite],
                               rtol=rtol, atol=rtol)
    # Σt below the floor: the flight is ell / tiny, as in the JAX package.
    huge = alive & (cls[np.clip(elem, 0, ntet - 1)] == 2)
    assert huge.any()
    np.testing.assert_array_equal(np.isfinite(dest.numpy()[huge]),
                                  np.isfinite(want[huge]))
    # Fed the JAX draws, the plain flight is the JAX formula's arithmetic.
    fed = source.flight_dest(
        torch.from_numpy(origin), torch.from_numpy(np.array(d)),
        torch.from_numpy(np.array(ell)),
        source.lane_sigma(t["class_id"], t["elem"], t["sigma_t"]),
        t["alive"])
    np.testing.assert_array_equal(fed.numpy()[finite], want[finite])


def test_sample_flight_refuses_bad_arguments():
    n = 4
    args = dict(pid=torch.zeros(n, dtype=torch.int32),
                elem=torch.zeros(n, dtype=torch.int32),
                alive=torch.ones(n, dtype=torch.bool),
                origin=torch.zeros(n, 3), class_id=torch.zeros(
                    2, dtype=torch.int32), sigma_t=torch.ones(1))
    with pytest.raises(TypeError, match="pid"):
        source_cuda.sample_flight((1, 2), **dict(
            args, pid=torch.zeros(n, dtype=torch.int64)), n_total=n)
    with pytest.raises(ValueError, match="n_total"):
        source_cuda.sample_flight((1, 2), n_total=0, **args)
    with pytest.raises(ValueError, match="u_out"):
        source_cuda.sample_flight((1, 2), n_total=n, u_out=torch.zeros(n, 4),
                                  **args)


def _physics_lanes(dtype):
    """Crafted lanes: reached (with and without downscatter), escaped,
    truncated, a material stop, roulette lucky and killed, dead."""
    f = NPDT[dtype]
    dest = np.array([[0.5, 0.5, 0.5]] * 9, f)
    pos = dest.copy()
    pos[1] = [0.0, 0.5, 0.5]      # escaped: mat -1, far from dest
    pos[3] = [0.2, 0.5, 0.5]      # truncated: mid-walk
    pos[4] = [0.3, 0.5, 0.5]      # material stop
    done = np.array([1, 1, 1, 0, 1, 1, 1, 1, 1], bool)
    mat = np.array([-1, -1, -1, -1, 2, -1, -1, -1, -1], np.int32)
    weight = np.array([1.0, 1.0, 0.7, 1.0, 1.0, 0.12, 0.12, 1.0, 0.05], f)
    group = np.array([0, 0, 1, 0, 0, 0, 0, 0, 0], np.int32)
    alive = np.array([1, 1, 1, 1, 1, 1, 1, 1, 0], bool)
    absorb = np.array([0.3, 0.3, 0.3, 0.3, 0.3, 0.5, 0.5, 0.3, 0.3], f)
    coll_u = np.array([0.2, 0.2, 0.1, 0.1, 0.1, 0.9, 0.9, 0.9, 0.1], f)
    roul_u = np.array([0.9, 0.9, 0.9, 0.9, 0.9, 0.2, 0.7, 0.9, 0.1], f)
    return pos, dest, done, mat, weight, group, alive, absorb, coll_u, roul_u


@pytest.mark.parametrize("n_groups", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_physics_against_jax(dtype, n_groups):
    lanes = _physics_lanes(dtype)
    kw = dict(eps_near=1e-4 * np.sqrt(3), survival_weight=0.1,
              downscatter=0.5, n_groups=n_groups)
    jw, jg, ja, jp = (np.asarray(a) for a in jsource.apply_physics(
        *(jnp.asarray(a) for a in lanes), **kw))
    tw, tg, ta, tp = (t.numpy() for t in source.apply_physics(
        *(torch.from_numpy(a) for a in lanes), **kw))
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tg, jg)
    assert _ulps(tw, jw) <= 1
    rtol = 1e-12 if dtype == torch.float64 else 1e-6
    np.testing.assert_allclose(tp, jp, rtol=rtol)
    # Every outcome occurred: reached, escaped, roulette killed, absorbed.
    assert jp[0] > 0 and jp[1] > 0 and jp[2] > 0 and jp[3] > 0
    if n_groups > 1:
        assert (tg > lanes[5]).any()  # downscatter


def test_source_params_tables_and_keys():
    kw = dict(sigma_t={1: 4.0, 3: 9.0}, absorption={2: 0.5},
              default_sigma_t=2.0, default_absorption=0.25,
              survival_weight=0.2, downscatter=0.4, seed=7)
    jp, tp = jsource.SourceParams(**kw), source.SourceParams(**kw)
    cid = np.array([0, 1, 1, 2, 5], np.int32)
    for a, b in zip(jp.tables(cid), tp.tables(cid)):
        np.testing.assert_array_equal(b, a)
    assert tp.physics_key() == jp.physics_key()
    assert tp.cache_key() == jp.cache_key()
    vec = np.array([3.0, 1.0, 2.0, 0.75, 5.0, 0.0])
    assert source.phys_to_dict(vec) == jsource.phys_to_dict(vec)
    assert source.MEGA_PHYS_FIELDS == jsource.MEGA_PHYS_FIELDS
    with pytest.raises(ValueError, match="physics vector"):
        source.phys_to_dict(vec[:4])
    cache = source.staged_tables(tp, torch.from_numpy(cid), torch.float32,
                                 "cpu")
    assert source.staged_tables(tp, cid, torch.float32, "cpu",
                                cache) is cache
    np.testing.assert_array_equal(cache[1].numpy(),
                                  tp.tables(cid)[0].astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_near_epsilon_equal(dtype):
    coords = np.random.default_rng(1).uniform(-1, 2, (50, 3)).astype(
        NPDT[dtype])
    assert source.near_epsilon(torch.from_numpy(coords)) == \
        jsource.near_epsilon(coords)
