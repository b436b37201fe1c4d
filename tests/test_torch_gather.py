"""The port's row gather (``ops/gather.py``) on the CPU: the plain version
against ``jnp.take`` on the geo20 table of a JAX box mesh, the wrapper's
argument checks, the piece-size helper, and the gather probe's byte count
and bound (the yardstick the kernel's time is read against).

The gather is exact: every comparison is bitwise, and a float64 geo20,
whose topology codes are int64 bit patterns, is compared through its
int64 view so that the codes' bits are what is checked. The kernel itself
runs only on the card (``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pumiumtally_tpu.mesh.box import build_box as jbuild_box
from pumiumtally_tpu_torch.ops import gather
from pumiumtally_tpu_torch.probes import gather_scatter as gs

_BITS = {np.float32: np.int32, np.float64: np.int64}


@pytest.mark.parametrize("n", [0, 1, 33, 4099])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_gather_of_geo20_matches_jnp_take(dtype, idx_dtype, n):
    geo = jbuild_box(1.0, 1.0, 1.0, 3, 2, 2, dtype=jnp.dtype(dtype)).geo20
    tbl = np.array(geo)
    assert tbl.dtype == dtype and tbl.shape == (72, 20)
    idx = np.random.default_rng(n).integers(0, tbl.shape[0], n).astype(
        idx_dtype)
    want = np.asarray(jnp.take(geo, jnp.asarray(idx), axis=0))
    t, i = torch.from_numpy(tbl), torch.from_numpy(idx)
    before = gather.LAUNCHES
    for got in (gather.gather_rows_plain(t, i), gather.gather_rows(t, i)):
        assert got.shape == (n, 20) and got.dtype == t.dtype
        np.testing.assert_array_equal(got.numpy().view(_BITS[dtype]),
                                      want.view(_BITS[dtype]))
    assert gather.LAUNCHES == before  # CPU tensors take the plain version


def test_plain_gather_keeps_nan_and_code_bits():
    """Words that are not finite floats (NaN payloads, int64 codes) come
    back with the same bits."""
    words = np.array([[0x7FF8000000000001, -1], [0x7FF0000000000000, 3]],
                     dtype=np.int64)
    tbl = torch.from_numpy(words.view(np.float64))
    got = gather.gather_rows(tbl, torch.tensor([1, 0, 1], dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy().view(np.int64),
                                  words[[1, 0, 1]])


def _args():
    return torch.zeros(6, 4, dtype=torch.float32), torch.tensor(
        [0, 5, 2], dtype=torch.int32)


@pytest.mark.parametrize("case,exc,match", [
    ("table rank", ValueError, r"\[R, C\]"),
    ("index rank", ValueError, r"\[R, C\]"),
    ("index dtype", TypeError, "int32 or int64"),
    ("element size", TypeError, "4- or 8-byte"),
    ("devices differ", ValueError, "idx is on"),
    ("table not contiguous", ValueError, "contiguous"),
    ("index not contiguous", ValueError, "contiguous"),
    ("neither cpu nor cuda", ValueError, "'cuda' or 'cpu'"),
])
def test_gather_rows_refuses(case, exc, match):
    tbl, idx = _args()
    if case == "table rank":
        tbl = tbl.reshape(-1)
    elif case == "index rank":
        idx = idx.reshape(3, 1)
    elif case == "index dtype":
        idx = idx.to(torch.int16)
    elif case == "element size":
        tbl = tbl.to(torch.float16)
    elif case == "devices differ":
        idx = torch.empty(3, dtype=torch.int32, device="meta")
    elif case == "table not contiguous":
        tbl = torch.zeros(4, 6).t()
    elif case == "index not contiguous":
        idx = torch.arange(6, dtype=torch.int32)[::2]
    else:
        tbl = torch.empty(6, 4, device="meta")
        idx = torch.empty(3, dtype=torch.int32, device="meta")
    with pytest.raises(exc, match=match):
        gather.gather_rows(tbl, idx)


@settings(max_examples=300, deadline=None)
@given(row_bytes=st.integers(1, 4096),
       ptrs=st.lists(st.integers(0, 1 << 40), min_size=0, max_size=3))
def test_piece_bytes_is_the_widest_that_divides(row_bytes, ptrs):
    fits = [p for p in (16, 8, 4)
            if row_bytes % p == 0 and all(a % p == 0 for a in ptrs)]
    if not fits:
        with pytest.raises(ValueError, match="4-byte words"):
            gather.piece_bytes(row_bytes, *ptrs)
        return
    piece = gather.piece_bytes(row_bytes, *ptrs)
    assert piece == max(fits)
    assert row_bytes % piece == 0 and all(a % piece == 0 for a in ptrs)


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_probe_bytes_and_bound(dtype, idx_dtype):
    """Each distinct row once, the output and the indices; the bound is
    those bytes over the card's HBM rate."""
    tbl = torch.arange(7 * 5, dtype=dtype).reshape(7, 5)
    idx = torch.tensor([3, 3, 0, 6, 0, 3, 1, 6, 6], dtype=idx_dtype)
    p = gs.gather_probe(tbl, idx)
    row, n, distinct = 5 * tbl.element_size(), 9, 4
    want = distinct * row + n * row + n * idx.element_size()
    assert p["ok"] and p["agree"] is True and p["max_abs_err"] == 0.0
    assert p["bytes_moved"] == want
    assert p["bound_usec"] == pytest.approx(want / 3.35e12 * 1e6, rel=1e-15)
    assert gs.HBM_BYTES_PER_S == 3.35e12
    assert p["shape"] == [7, 5, 9] and p["plain"] is True
    assert p["usec_per_call"] is None and p["gbps"] is None
