"""The port's tally scatter and row gather (``ops/scatter.py``,
``ops/gather.py``) against the JAX probe kernels, and the ordered fold
against a sequential replay.

The JAX side is ``scripts/probe_pallas_gather.py``, loaded by path and
unchanged; its Pallas kernels run in interpret mode on the CPU, as the
probe itself runs them off a TPU. Tolerances: the ordered scatter and the
gather are bitwise (the probe asserts ``peeled`` bitwise against its
ascending-lane reference); the atomic scatter agrees with ``outer``
within the probe's rtol 1e-5 (a one-hot product sums in another order).
"""
from __future__ import annotations

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pumiumtally_tpu_torch.ops import gather, scatter
from pumiumtally_tpu_torch.ops import walk as twalk

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "probe_pallas_gather", ROOT / "scripts" / "probe_pallas_gather.py"
)
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

SHAPES = [(128, 384, 2), (128, 6000, 2)]


def _jax_scatter(make_kernel, B, ntet, G):
    elem, group, contrib, acc0 = probe._scatter_inputs(B, ntet, G)
    f = pl.pallas_call(
        make_kernel(B, ntet, G),
        out_shape=jax.ShapeDtypeStruct((ntet, 2 * G), jnp.float32),
        interpret=True,
    )
    out = np.asarray(jax.jit(f)(elem, group, contrib, acc0))
    ref = probe._scatter_reference(elem, group, contrib, acc0)
    recs = (np.asarray(elem), np.asarray(group), np.asarray(contrib))
    return out, ref, recs


def _port_records(elem, group, contrib, G):
    return (
        torch.from_numpy((elem * G + group).astype(np.int32)),
        torch.arange(elem.shape[0], dtype=torch.int64),
        torch.from_numpy(contrib.copy()),
    )


@pytest.mark.parametrize("B,ntet,G", SHAPES)
def test_ordered_plain_matches_jax_peeled(B, ntet, G):
    out, ref, (elem, group, contrib) = _jax_scatter(
        probe.make_k_peeled, B, ntet, G)
    bin, order, c = _port_records(elem, group, contrib, G)
    flux = torch.zeros(ntet * 2 * G, dtype=torch.float32)
    got = scatter.scatter_ordered_plain(flux, bin, order, c).numpy()
    np.testing.assert_array_equal(got.reshape(ntet, 2 * G), out)
    np.testing.assert_array_equal(got.reshape(ntet, 2 * G), ref)


@pytest.mark.parametrize("B,ntet,G", SHAPES)
def test_atomic_plain_matches_jax_outer(B, ntet, G):
    out, _, (elem, group, contrib) = _jax_scatter(
        probe.make_k_outer, B, ntet, G)
    bin, _, c = _port_records(elem, group, contrib, G)
    flux = torch.zeros(ntet * 2 * G, dtype=torch.float32)
    got = scatter.scatter_atomic_plain(flux, bin, c).numpy()
    np.testing.assert_allclose(got.reshape(ntet, 2 * G), out, rtol=1e-5)


def test_gather_plain_matches_jax_take():
    tbl = np.random.default_rng(0).normal(size=(probe.T, probe.C)).astype(
        np.float32)
    idx = np.random.default_rng(1).integers(0, probe.T, (probe.N,)).astype(
        np.int32)
    f = pl.pallas_call(
        probe.k_take,
        out_shape=jax.ShapeDtypeStruct((probe.N, probe.C), jnp.float32),
        interpret=True,
    )
    out = np.asarray(jax.jit(f)(jnp.asarray(tbl), jnp.asarray(idx)))
    t, i = torch.from_numpy(tbl), torch.from_numpy(idx)
    np.testing.assert_array_equal(gather.gather_rows_plain(t, i).numpy(), out)
    before = gather.LAUNCHES
    np.testing.assert_array_equal(gather.gather_rows(t, i).numpy(), out)
    assert gather.LAUNCHES == before  # CPU tensors take the plain version


def _replay(flux0, bin, order, c, score_squares):
    """numpy sequential fold in ascending (order, record index)."""
    f = flux0.copy()
    for r in np.lexsort((np.arange(order.shape[0]), order)):
        v = c[r]
        f[2 * bin[r]] = f[2 * bin[r]] + v
        if score_squares:
            f[2 * bin[r] + 1] = f[2 * bin[r] + 1] + v * v
    return f


def _records(m, nbins, np_dtype, seed, ties=False):
    """Records with many collisions (a third in one hot bin), keys in
    shuffled record order, contributions spanning several binades."""
    rng = np.random.default_rng(seed)
    bin = rng.integers(0, nbins, m)
    bin[rng.uniform(size=m) < 0.3] = 3
    order = (rng.integers(0, m // 8, m) if ties
             else rng.permutation(5 * m)[:m])
    c = (rng.uniform(0.5, 1.0, m) * 2.0 ** rng.integers(-12, 4, m))
    return bin.astype(np.int32), order.astype(np.int64), c.astype(np_dtype)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("score_squares", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ordered_fold_matches_sequential_replay(dtype, score_squares, ties):
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    m, nbins = 3000, 40
    bin, order, c = _records(m, nbins, np_dtype, seed=7, ties=ties)
    flux0 = np.random.default_rng(8).uniform(0, 3, 2 * nbins).astype(np_dtype)
    want = _replay(flux0, bin, order, c, score_squares)
    t = torch.from_numpy
    before = scatter.ORDERED_LAUNCHES
    for fn in (scatter.scatter_ordered_plain, scatter.scatter_ordered):
        got = fn(t(flux0.copy()), t(bin), t(order), t(c), score_squares)
        np.testing.assert_array_equal(got.numpy(), want)
    assert scatter.ORDERED_LAUNCHES == before  # CPU: the plain version
    # The order matters: ascending record order would give other bits.
    other = _replay(flux0, bin, np.arange(m), c, score_squares)
    assert not np.array_equal(other, want)


def test_scatter_wrappers_check_their_arguments():
    f = torch.zeros(8)
    b = torch.zeros(3, dtype=torch.int32)
    c = torch.ones(3)
    o = torch.arange(3)
    with pytest.raises(TypeError, match="bin"):
        scatter.scatter_ordered(f, b.long(), o, c)
    with pytest.raises(TypeError, match="order"):
        scatter.scatter_ordered(f, b, o.int(), c)
    with pytest.raises(TypeError, match="c must"):
        scatter.scatter_atomic(f, b, c.double())
    with pytest.raises(ValueError, match="flat"):
        scatter.scatter_atomic(torch.zeros(4, 2), b, c)
    with pytest.raises(ValueError, match="shape"):
        scatter.scatter_ordered(f, b, o[:2], c)
    got = scatter.scatter_atomic(f.clone(), b, c, score_squares=False)
    assert got.tolist() == [3.0] + [0.0] * 7


@pytest.mark.parametrize("score_squares", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_walk_flux_is_the_replay_of_its_records(
        monkeypatch, dtype, score_squares):
    """The plain walk hands each iteration's records to the ordered
    scatter keyed ``iteration · n + lane``; a numpy fold of all of them in
    key order gives the walk's flux bit for bit."""
    from pumiumtally_tpu_torch.mesh.box import build_box_arrays
    from pumiumtally_tpu_torch.mesh.core import TetMesh

    nx, n, G = 4, 300, 3
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, nx, nx, nx)
    rng = np.random.default_rng(12)
    interior = (coords > 1e-9).all(axis=1) & (coords < 1 - 1e-9).all(axis=1)
    coords = coords.copy()
    coords[interior] += rng.uniform(-0.2 / nx, 0.2 / nx, (interior.sum(), 3))
    mesh = TetMesh.from_numpy(coords, tets, dtype=dtype, device="cpu")
    # Half the lanes start in one element, so bins collide.
    elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
    elem[: n // 2] = 5
    t = torch.from_numpy
    elem = t(elem)
    origin = mesh.centroids()[elem.long()].contiguous()
    dest = t(rng.uniform(-0.1, 1.1, (n, 3))).to(dtype)
    fly = t(rng.uniform(size=n) > 0.1)
    w = t(rng.uniform(0.5, 2.0, n)).to(dtype)
    g = t(rng.integers(0, G, n).astype(np.int32))
    g[: n // 2] = 0
    mat = torch.full((n,), -1, dtype=torch.int32)
    flux0 = t(np.random.default_rng(9).uniform(0, 1, mesh.ntet * G * 2)).to(
        dtype)

    calls = []
    real = twalk.scatter_ordered_plain

    def recording(flux, bin, order, c, sq):
        calls.append((bin.numpy().copy(), order.numpy().copy(),
                      c.numpy().copy()))
        return real(flux, bin, order, c, sq)

    monkeypatch.setattr(twalk, "scatter_ordered_plain", recording)
    res = twalk.trace(mesh, origin, dest, elem, fly, w, g, mat,
                      flux0.clone(), initial=False,
                      max_crossings=mesh.ntet + 8, n_groups=G,
                      score_squares=score_squares)
    assert bool(res.done.all())
    bin = np.concatenate([b for b, _, _ in calls])
    order = np.concatenate([o for _, o, _ in calls])
    c = np.concatenate([v for _, _, v in calls])
    for it, (_, o, _) in enumerate(calls):
        assert (o // n == it).all()  # keyed iteration · n + lane
        assert np.unique(o % n).size == o.size
    assert np.bincount(bin).max() >= n // 4
    want = _replay(flux0.numpy(), bin, order, c, score_squares)
    np.testing.assert_array_equal(res.flux.numpy(), want)
