"""The bucket decomposition of the ordered scatter (``ops/scatter.py``).

On the card the ordered scatter partitions its records into buckets of
``2^shift`` consecutive bins, in an order within each bucket that is the
device's, each record as a key that packs (local bin, order, record
index), and folds every bucket on its own, each bin in key order. These
tests play that decomposition with the plain version on the CPU: records
bucketed with the wrapper's own shift, shuffled within their buckets, each
bucket folded by ``scatter_ordered_plain`` keyed by ``bucket_keys_plain``
and the buckets in reverse order, give the one-shot
``scatter_ordered_plain`` flux bit for bit, and the JAX probe's
``make_k_peeled`` kernel's (interpret mode, as tests/test_torch_scatter.py
runs it). Also the keys, the bucket sizing and the crowded test that sends
a call to the other path.
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

from pumiumtally_tpu_torch.ops import scatter

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "probe_pallas_gather", ROOT / "scripts" / "probe_pallas_gather.py"
)
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

# The main path's first move: records and bins (PERF.md §5).
MOVE1_RECORDS, MOVE1_BINS = 16_934_705, 998_250 * 8


def _records(m, nbins, np_dtype, seed, ties=False):
    """Records with many collisions (a third in one hot bin), keys in
    shuffled record order, contributions spanning several binades (the
    shapes of tests/test_torch_scatter.py)."""
    rng = np.random.default_rng(seed)
    bin = rng.integers(0, nbins, m)
    bin[rng.uniform(size=m) < 0.3] = 3
    order = (rng.integers(0, m // 8, m) if ties
             else rng.permutation(5 * m)[:m])
    c = (rng.uniform(0.5, 1.0, m) * 2.0 ** rng.integers(-12, 4, m))
    return bin.astype(np.int32), order.astype(np.int64), c.astype(np_dtype)


def _bucketed(flux0, bin, order, c, score_squares, seed=0):
    """Fold the records bucket by bucket, as the bucket path does: the
    shift from ``scatter.bucket_shift``, each bucket's records in a
    shuffled arrival order, each folded in the order of its key (which
    carries the record's original index, the tie-break), the buckets in
    reverse order."""
    m, nbins = bin.shape[0], flux0.shape[0] // 2
    shift = scatter.bucket_shift(m, nbins)
    bucket = bin.astype(np.int64) >> shift
    key = scatter.bucket_keys_plain(torch.from_numpy(bin),
                                    torch.from_numpy(order), shift).numpy()
    arrival = np.random.default_rng(seed).permutation(m)
    flux = torch.from_numpy(flux0.copy())
    for k in reversed(range(scatter.n_buckets(nbins, shift))):
        sel = arrival[bucket[arrival] == k]
        if sel.size == 0:
            continue
        scatter.scatter_ordered_plain(
            flux, torch.from_numpy(bin[sel]), torch.from_numpy(key[sel]),
            torch.from_numpy(c[sel]), score_squares)
    return flux.numpy(), shift


@pytest.mark.parametrize("m,nbins,crowded", [
    (3000, 40, False), (3000, 45, False), (20000, 5001, True)])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("score_squares", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bucket_decomposition_is_bitwise_the_one_shot_fold(
        dtype, score_squares, ties, m, nbins, crowded):
    """Any bucketing folds to the one-shot bits; at 20,000 records the hot
    bin overfills its bucket, so the card would take the crowded path."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    bin, order, c = _records(m, nbins, np_dtype, seed=m + nbins, ties=ties)
    flux0 = np.random.default_rng(8).uniform(0, 3, 2 * nbins).astype(np_dtype)
    t = torch.from_numpy
    want = scatter.scatter_ordered_plain(t(flux0.copy()), t(bin), t(order),
                                         t(c), score_squares).numpy()
    got, shift = _bucketed(flux0, bin, order, c, score_squares)
    np.testing.assert_array_equal(got, want)
    assert shift > 0
    assert bool(nbins % (1 << shift)) == (nbins != 40)  # a short last bucket
    sizes = scatter.bucket_counts_plain(t(bin), nbins, shift)
    assert int(sizes.sum()) == m
    assert scatter.is_crowded(int(sizes.max())) == crowded


@pytest.mark.parametrize("seed", range(4))
def test_bucket_fold_breaks_ties_by_record_index(seed):
    """Three float32 records of one bin and one order: in record order
    1e8 - 1e8 + 1 gives 1, the arrival orders that put the 1 second give
    0. The bucketed fold keeps the record order whatever the arrival."""
    c = np.array([1e8, -1e8, 1.0, 0.5], np.float32)
    bin = np.array([0, 0, 0, 1], np.int32)
    order = np.zeros(4, np.int64)
    got, _ = _bucketed(np.zeros(4, np.float32), bin, order, c, False, seed)
    assert got.tolist() == [1.0, 0.0, 0.5, 0.0]
    swapped = scatter.scatter_ordered_plain(
        torch.zeros(4), torch.from_numpy(bin[[0, 2, 1, 3]]),
        torch.from_numpy(order), torch.from_numpy(c[[0, 2, 1, 3]]), False)
    assert swapped.tolist() == [0.0, 0.0, 0.5, 0.0]


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("shift", [0, 3, 8, 10])
def test_bucket_keys_order_records_by_bin_order_index(shift, ties):
    """Within a bucket the keys' order is (bin, order, record index), with
    negative and repeated orders; keys are distinct and not negative."""
    bin, order, _ = _records(5000, 3000, np.float32, seed=shift, ties=ties)
    order = order - 1000
    key = scatter.bucket_keys_plain(torch.from_numpy(bin),
                                    torch.from_numpy(order), shift).numpy()
    assert (key >= 0).all() and np.unique(key).size == key.size
    bucket = bin >> shift
    want = np.lexsort((np.arange(bin.size), order, bin, bucket))
    got = np.lexsort((key, bucket))
    np.testing.assert_array_equal(got, want)


def test_keys_that_do_not_fit_are_refused():
    m = 1000
    assert scatter.key_bits(m, 0) == (0, 10)
    assert scatter.key_bits(1, 5) == (3, 1)
    assert scatter.key_bits(16_934_705, 233 * 2**20) == (28, 25)
    bin = torch.zeros(2, dtype=torch.int32)
    scatter.bucket_keys_plain(bin, torch.tensor([0, 2**61]), 0)
    with pytest.raises(ValueError, match="fit 63"):
        scatter.bucket_keys_plain(bin, torch.tensor([0, 2**61]), 1)
    with pytest.raises(ValueError, match="fit 63"):
        scatter.bucket_keys_plain(bin, torch.tensor([-2**62, 2**62]), 0)


@pytest.mark.parametrize("B,ntet,G", [(128, 384, 2), (128, 6000, 2)])
def test_bucketed_fold_matches_jax_peeled(B, ntet, G):
    """Mirrors test_torch_scatter.py::test_ordered_plain_matches_jax_peeled
    with the records folded bucket by bucket."""
    elem, group, contrib, acc0 = probe._scatter_inputs(B, ntet, G)
    f = pl.pallas_call(
        probe.make_k_peeled(B, ntet, G),
        out_shape=jax.ShapeDtypeStruct((ntet, 2 * G), jnp.float32),
        interpret=True,
    )
    out = np.asarray(jax.jit(f)(elem, group, contrib, acc0))
    bin = (np.asarray(elem) * G + np.asarray(group)).astype(np.int32)
    order = np.arange(B, dtype=np.int64)
    got, shift = _bucketed(np.zeros(ntet * 2 * G, np.float32), bin, order,
                           np.asarray(contrib).copy(), True)
    assert shift == scatter.MAX_SHIFT
    np.testing.assert_array_equal(got.reshape(ntet, 2 * G), out)


@pytest.mark.parametrize("m", [0, 1, 683, 2048, 10**5, MOVE1_RECORDS, 2**31 - 1])
@pytest.mark.parametrize("nbins", [1, 1000, 4097, MOVE1_BINS])
def test_bucket_shift_sizes_the_mean_bucket(m, nbins):
    cap = scatter.BUCKET_CAPACITY
    shift = scatter.bucket_shift(m, nbins)
    assert 0 <= shift <= scatter.MAX_SHIFT
    if shift:
        assert 3 * m <= cap * scatter.n_buckets(nbins, shift)
    if shift < scatter.MAX_SHIFT:  # one more doubling would overfill it
        assert 3 * m > cap * scatter.n_buckets(nbins, shift + 1)


def test_move_one_takes_buckets_of_256_bins():
    shift = scatter.bucket_shift(MOVE1_RECORDS, MOVE1_BINS)
    assert shift == 8
    nb = scatter.n_buckets(MOVE1_BINS, shift)
    assert nb == 31_196
    assert MOVE1_RECORDS / nb <= scatter.BUCKET_CAPACITY / 3  # mean 543


@pytest.mark.parametrize("case", ["point source", "uniform"])
def test_crowded_test(case):
    """A point source puts most records in a few bins: its largest bucket
    overflows a block and the call is crowded. Uniform records are not."""
    rng = np.random.default_rng(3)
    m, nbins = 200_000, 8 * 6000
    bin = rng.integers(0, nbins, m)
    if case == "point source":  # most lanes score in one element's bins
        hot = rng.uniform(size=m) < 0.7
        bin[hot] = 8 * 2500 + rng.integers(0, 8, int(hot.sum()))
    bin = torch.from_numpy(bin.astype(np.int32))
    shift = scatter.bucket_shift(m, nbins)
    largest = int(scatter.bucket_counts_plain(bin, nbins, shift).max())
    assert scatter.is_crowded(largest) == (case == "point source")
    assert not scatter.is_crowded(scatter.BUCKET_CAPACITY)
    assert scatter.is_crowded(scatter.BUCKET_CAPACITY + 1)


def test_cpu_tensors_take_neither_path():
    bin, order, c = _records(500, 30, np.float32, seed=1)
    t = torch.from_numpy
    counts = (scatter.ORDERED_LAUNCHES, scatter.BUCKET_LAUNCHES,
              scatter.CROWDED_LAUNCHES)
    got = scatter.scatter_ordered(torch.zeros(60), t(bin), t(order), t(c))
    want = scatter.scatter_ordered_plain(torch.zeros(60), t(bin), t(order),
                                         t(c))
    assert torch.equal(got, want)
    assert counts == (scatter.ORDERED_LAUNCHES, scatter.BUCKET_LAUNCHES,
                      scatter.CROWDED_LAUNCHES)
