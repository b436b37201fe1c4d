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
import math
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


# The assembly cell's flux (119^3 cubes of 6 tets, 70 groups) and its
# records a move on an H100: up to 11,953,477 (largest bucket 96) in a
# batch's first moves, a few thousand in its tail (PERF.md §6).
ASSEMBLY_BINS = 119 ** 3 * 6 * 70
ASSEMBLY_FULL, ASSEMBLY_TAIL = 11_953_477, 3_000


@pytest.mark.parametrize("m,nbins,largest,want", [
    (ASSEMBLY_FULL, ASSEMBLY_BINS, 96, "sparse"),
    (ASSEMBLY_TAIL, ASSEMBLY_BINS, 3, "sparse"),
    (MOVE1_RECORDS, MOVE1_BINS, 700, "bucket"),
    (200_000, 8 * 6000, scatter.BUCKET_CAPACITY + 1, "crowded"),
    (ASSEMBLY_TAIL, ASSEMBLY_BINS, scatter.BUCKET_CAPACITY + 1, "crowded"),
], ids=["assembly full width", "assembly tail", "move 1",
        "point source", "sparse but crowded"])
def test_fold_path_follows_the_density(m, nbins, largest, want):
    """The assembly's moves take the sparse fold, the main path's move 1
    the dense one, and a crowded call neither, whatever its density."""
    shift = scatter.bucket_shift(m, nbins)
    obits, ibits = scatter.key_bits(m, 233 * 2**20)
    assert scatter.fold_path(m, nbins, largest,
                             shift + obits + ibits) == want


def test_fold_path_crossover_and_wide_keys():
    nbins = 1 << 24
    at = math.ceil(scatter.SPARSE_BELOW * nbins)
    assert scatter.fold_path(at - 1, nbins, 1, 40) == "sparse"
    assert scatter.fold_path(at, nbins, 1, 40) == "bucket"
    assert scatter.fold_path(at - 1, nbins, 1, 64) == "crowded"
    assert scatter.fold_path(at, nbins, 1, 63) == "bucket"


def sparse_fold_plain(flux, bin, order, c, shift: int,
                      score_squares: bool = True):
    """The sparse fold's plain model: every record's key
    (``bucket_keys_plain``), the records of each bucket of ``2^shift``
    bins sorted by key, nothing built per bin, and each run of one bin
    folded in that order. The runs are folded a position at a time, so
    that each round adds to every bin at most once. Updates ``flux`` in
    place and returns it."""
    if bin.numel() == 0:
        return flux
    flux2 = flux.view(-1, 2)
    key = scatter.bucket_keys_plain(bin, order, shift)
    by_key = torch.argsort(key)
    perm = by_key[torch.argsort(bin.long()[by_key] >> shift, stable=True)]
    sbin = bin.long()[perm]
    m = sbin.numel()
    pos = torch.arange(m, device=bin.device)
    head = torch.ones(m, dtype=torch.bool, device=bin.device)
    head[1:] = sbin[1:] != sbin[:-1]
    at = pos - torch.cummax(torch.where(head, pos, 0), dim=0).values
    for r in range(int(at.max()) + 1):
        sel = perm[at == r]
        b, v = bin.long()[sel], c[sel]
        flux2[:, 0].index_add_(0, b, v)
        if score_squares:
            flux2[:, 1].index_add_(0, b, v * v)
    return flux


def _sparse_case(np_dtype, ties, seed=0):
    """Records in buckets of 2^10 bins of 1, 32, 33 and BUCKET_CAP records,
    one with a bin of 40 records, empty buckets, and a ragged last bucket
    of 100 bins; in shuffled record order."""
    rng = np.random.default_rng(seed)
    width = 1 << scatter.MAX_SHIFT
    nbins = 8 * width + 100
    parts = [np.full(1, 5),                               # bucket 0: 1
             width + rng.integers(0, width, 32),          # bucket 1: 32
             2 * width + rng.integers(0, width, 33),      # bucket 2: 33
             3 * width + rng.integers(0, width, scatter.BUCKET_CAPACITY),
             np.full(40, 5 * width + 17),                 # bucket 5: a bin
             5 * width + rng.integers(0, width, 20),      # of 40, and 20
             8 * width + rng.integers(0, 100, 50)]        # ragged: 50
    bin = rng.permutation(np.concatenate(parts))
    m = bin.size
    order = (rng.integers(0, 16, m) if ties else rng.permutation(4 * m)[:m])
    c = rng.uniform(0.5, 1.0, m) * 2.0 ** rng.integers(-12, 4, m)
    return (bin.astype(np.int32), order.astype(np.int64), c.astype(np_dtype),
            nbins)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("score_squares", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sparse_fold_plain_is_bitwise_the_one_shot_fold(dtype, score_squares,
                                                        ties):
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    bin, order, c, nbins = _sparse_case(np_dtype, ties)
    t = torch.from_numpy
    shift = scatter.bucket_shift(bin.size, nbins)
    assert shift == scatter.MAX_SHIFT
    sizes = scatter.bucket_counts_plain(t(bin), nbins, shift).tolist()
    assert sizes == [1, 32, 33, scatter.BUCKET_CAPACITY, 0, 60, 0, 0, 50]
    assert not scatter.is_crowded(max(sizes))
    flux0 = np.random.default_rng(8).uniform(0, 3, 2 * nbins).astype(np_dtype)
    want = scatter.scatter_ordered_plain(t(flux0.copy()), t(bin), t(order),
                                         t(c), score_squares)
    got = sparse_fold_plain(t(flux0.copy()), t(bin), t(order), t(c),
                                    shift, score_squares)
    assert torch.equal(got, want)
    if not score_squares:
        assert torch.equal(got[1::2], t(flux0[1::2]))


@pytest.mark.parametrize("swap", [False, True])
def test_sparse_fold_plain_breaks_ties_by_record_index(swap):
    """test_bucket_fold_breaks_ties_by_record_index's records through the
    sparse model: in record order 1e8 - 1e8 + 1 gives 1, with the 1 second
    it gives 0."""
    c = np.array([1e8, -1e8, 1.0, 0.5], np.float32)
    if swap:
        c = c[[0, 2, 1, 3]]
    t = torch.from_numpy
    got = sparse_fold_plain(
        torch.zeros(4), t(np.array([0, 0, 0, 1], np.int32)),
        torch.zeros(4, dtype=torch.int64), t(c), 0, False)
    assert got.tolist() == [0.0 if swap else 1.0, 0.0, 0.5, 0.0]


def test_sparse_fold_plain_without_records_leaves_the_flux():
    flux = torch.arange(8.0)
    empty = torch.zeros(0, dtype=torch.int32)
    got = sparse_fold_plain(flux.clone(), empty,
                                    torch.zeros(0, dtype=torch.int64),
                                    torch.zeros(0), 10)
    assert torch.equal(got, flux)
