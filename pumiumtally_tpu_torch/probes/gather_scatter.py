"""Probe of the gather (K2) and tally scatter (K3) kernels.

    python -m pumiumtally_tpu_torch.probes.gather_scatter [--device cuda] [--out PATH]

The port's counterpart of ``scripts/probe_pallas_gather.py``. It runs

* ``gather``: ``ops/gather.py::gather_rows`` at the JAX probe's shape
  (table [4096, 16] float32, 2048 indices) and at the walk's: the geo20
  table of the 55³-cell box ([998,250, 20] float32) gathered at
  16,934,705 random indices, one per lane iteration of the main path's
  first move;
* ``scatter_atomic`` and ``scatter_ordered``: ``ops/scatter.py`` at the
  JAX probe's three ``SCATTER_SHAPES`` and at the walk's: one move's
  records into the 998,250 × 8 group flux. A caller with a walk's real
  records passes them to ``run``; standalone, the probe draws a seeded
  stand-in with the same counts (uniform bins, input order shuffled).

Each probe records ``ok``, microseconds per call (CUDA events, median of
5 after a warm-up), GB/s of the bytes the call must move, its agreement with the
plain version (bitwise for the gather and the ordered scatter, rtol 1e-5
for the atomic one, as the JAX probe) and a library time where one
PyTorch call computes the same function (``torch.index_select``,
``Tensor.index_add_``; for the ordered scatter ``Tensor.index_put_`` with
``accumulate=True`` on records sorted by ``order``, reported only where it
came out bitwise equal, else null).

With ``--device cpu`` it runs the plain versions only (the wrappers take
them for CPU tensors), records agreement and no times, and marks the JSON
``"plain": true``: the counterpart of the JAX probe's ``"interpret"``.
The JSON's ``device`` names the card and its power limit. Nothing is
written unless ``--out`` is given.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from ..ops import gather, scatter

T, C, N = 4096, 16, 2048  # the JAX probe's gather table and lanes
SCATTER_SHAPES = (  # (records B, ntet, groups), the JAX probe's own
    (128, 384, 2),
    (128, 6000, 2),
    (128, 41154, 4),
)
# The main path's first move (55³-cell box, 1,048,576 particles, 8 groups):
# its lane iterations, each of which scores one record.
WALK_CELLS, WALK_GROUPS, WALK_RECORDS = 55, 8, 16_934_705
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
ATOMIC_RTOL = 1e-5


def card() -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.split(",", 1))
    return {"name": name, "power_limit": limit, "torch_name":
            torch.cuda.get_device_name(0)}


def event_us(fn, reps: int, setup=None) -> float:
    """Median over ``reps`` of one call's device time in microseconds
    (CUDA events), after one warm-up call."""
    times = []
    for r in range(reps + 1):
        args = setup() if setup is not None else ()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        if r:
            times.append(a.elapsed_time(b) * 1e3)
    return float(np.median(times))


def _entry(probe, shape, ok, *, agree, bytes_moved, device, max_abs_err=None,
           us=None, plain_us=None, library_us=None, library=None, error=None):
    timed = us is not None
    return dict(
        probe=probe, shape=list(shape), ok=bool(ok), agree=agree,
        max_abs_err=max_abs_err,
        usec_per_call=us, plain_usec_per_call=plain_us,
        library=library, library_usec_per_call=library_us,
        bytes_moved=bytes_moved,
        gbps=bytes_moved / us / 1e3 if timed else None,
        bound_usec=bytes_moved / HBM_BYTES_PER_S * 1e6,
        error=error, plain=device.type == "cpu",
    )


def gather_probe(tbl, idx, reps: int = 5) -> dict:
    """Hold ``gather_rows`` against ``tbl[idx]`` (bitwise: the words'
    integer views, so -0.0 and code bits count) and, on the
    card, time it, the plain version and ``torch.index_select``. The bytes
    it must move: each distinct row once, the output, the indices."""
    shape = (*tbl.shape, idx.numel())
    row_bytes = tbl.shape[1] * tbl.element_size()
    nbytes = (torch.unique(idx).numel() * row_bytes + idx.numel() * row_bytes
              + idx.numel() * idx.element_size())
    try:
        out = gather.gather_rows(tbl, idx)
        ref = gather.gather_rows_plain(tbl, idx)
        bits = torch.int32 if tbl.element_size() == 4 else torch.int64
        agree = bool(torch.equal(out.view(bits), ref.view(bits)))
        err = float((out.double() - ref.double()).abs().max()) if out.numel() \
            else 0.0
        del out, ref
        times = {}
        if tbl.device.type == "cuda":
            times = dict(
                us=event_us(lambda: gather.gather_cuda(tbl, idx), reps),
                plain_us=event_us(lambda: gather.gather_rows_plain(tbl, idx),
                                  reps),
                library_us=event_us(lambda: torch.index_select(tbl, 0, idx),
                                    reps),
                library="torch.index_select",
            )
        return _entry("gather", shape, agree, agree=agree, bytes_moved=nbytes,
                      device=tbl.device, max_abs_err=err, **times)
    except Exception as e:  # recorded, as the JAX probe records failures
        return _entry("gather", shape, False, agree=None, bytes_moved=nbytes,
                      device=tbl.device, error=f"{type(e).__name__}: {e}")


def library_ordered(flux, bin, order, c):
    """``index_put_(accumulate=True)`` on records sorted by order (stable):
    on the card it sorts the indices stably and adds each run of equal
    indices in that order, which may or may not be the fold's bits."""
    perm = torch.argsort(order, stable=True)
    cs = c[perm]
    flux.view(-1, 2).index_put_(
        (bin[perm].long(),), torch.stack((cs, cs * cs), 1), accumulate=True
    )
    return flux


def scatter_probe(kind: str, flux0, bin, order, c, shape, reps: int = 5,
                  score_squares: bool = True) -> dict:
    """Hold ``scatter_<kind>`` against its plain version (bitwise for
    ``ordered``, rtol 1e-5 for ``atomic``) and, on the card, time it, the
    plain version and the library call. The bytes it must move: the
    records' (bin, c) and, ordered, their order keys; each touched bin
    read and written once. ``flux0`` is not changed."""
    item = flux0.element_size()
    m = bin.numel()
    nbytes = (m * (4 + item + (8 if kind == "ordered" else 0))
              + torch.unique(bin).numel() * 2 * 2 * item)
    probe = f"scatter_{kind}"
    try:
        if kind == "ordered":
            def run(f):
                return scatter.scatter_ordered(f, bin, order, c, score_squares)

            def plain(f):
                return scatter.scatter_ordered_plain(f, bin, order, c,
                                                     score_squares)
        else:
            def run(f):
                return scatter.scatter_atomic(f, bin, c, score_squares)

            def plain(f):
                return scatter.scatter_atomic_plain(f, bin, c, score_squares)
        got, ref = run(flux0.clone()), plain(flux0.clone())
        err = float((got.double() - ref.double()).abs().max())
        if kind == "ordered":
            agree = bool(torch.equal(got, ref))
            ok = agree
        else:
            g, r = got.double(), ref.double()
            rel = float(((g - r).abs() / r.abs().clamp_min(1e-300)).max()) \
                if m else 0.0
            agree, ok = rel, rel <= ATOMIC_RTOL
        times = {}
        if flux0.device.type == "cuda":
            # Time the launchers the walk calls, past the wrappers' checks.
            nbins = flux0.numel() // 2
            if kind == "ordered":
                def launch(f):
                    scatter.ordered_cuda(f, bin, order, c, score_squares,
                                         nbins)
            else:
                def launch(f):
                    scatter.atomic_cuda(f, bin, c, score_squares)

            def fresh():
                return (flux0.clone(),)

            times = dict(us=event_us(launch, reps, fresh),
                         plain_us=event_us(plain, reps, fresh))
            if kind == "atomic":
                v = torch.stack((c, c * c), 1)
                b = bin.long()
                times["library_us"] = event_us(
                    lambda f: f.view(-1, 2).index_add_(0, b, v), reps, fresh)
                times["library"] = "Tensor.index_add_"
            elif score_squares and torch.equal(
                library_ordered(flux0.clone(), bin, order, c), ref
            ):
                times["library_us"] = event_us(
                    lambda f: library_ordered(f, bin, order, c), reps, fresh)
                times["library"] = ("torch.argsort + "
                                    "Tensor.index_put_(accumulate=True)")
        return _entry(probe, shape, ok, agree=agree, bytes_moved=nbytes,
                      device=flux0.device, max_abs_err=err, **times)
    except Exception as e:
        return _entry(probe, shape, False, agree=None, bytes_moved=nbytes,
                      device=flux0.device, error=f"{type(e).__name__}: {e}")


def probe_scatter_inputs(B, ntet, G, device, seed=2):
    """The JAX probe's scatter inputs (``_scatter_inputs``): B records with
    seeded elements, groups and float32 contributions, a zero flux; the
    order key is the lane."""
    rng = np.random.default_rng(seed)
    elem = rng.integers(0, ntet, (B,)).astype(np.int32)
    group = rng.integers(0, G, (B,)).astype(np.int32)
    contrib = rng.uniform(0.1, 2.0, (B,)).astype(np.float32)
    return dict(
        flux=torch.zeros(ntet * 2 * G, dtype=torch.float32, device=device),
        bin=torch.from_numpy(elem * G + group).to(device),
        order=torch.arange(B, dtype=torch.int64, device=device),
        c=torch.from_numpy(contrib).to(device),
    )


def walk_stand_in(nbins, m, device, dtype=torch.float32, seed=5):
    """A seeded stand-in for one move's m records: the order keys
    0..m-1 (iteration·lanes + lane for every lane iteration) in shuffled
    record order, uniform bins, segment-like contributions."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(m)
    return dict(
        flux=torch.zeros(nbins * 2, dtype=dtype, device=device),
        bin=torch.from_numpy(rng.integers(0, nbins, m).astype(np.int32)).to(device),
        order=torch.from_numpy(perm.astype(np.int64)).to(device),
        c=torch.from_numpy(rng.uniform(1e-3, 0.08, m)).to(device, dtype),
    )


def run(device, *, reps=5, geo20=None, records=None, walk_cells=WALK_CELLS,
        walk_records=WALK_RECORDS, walk_groups=WALK_GROUPS) -> dict:
    """Every probe on ``device``; returns the JSON payload. ``geo20`` is
    the walk's table (default: the geo20 of a ``walk_cells``³ box) and
    ``records`` a dict of ``flux``, ``bin``, ``order``, ``c`` from a real
    walk (default: ``walk_stand_in``)."""
    from ..mesh.box import build_box

    device = torch.device(device)
    results = []
    rng0, rng1 = np.random.default_rng(0), np.random.default_rng(1)
    tbl = torch.from_numpy(rng0.normal(size=(T, C)).astype(np.float32))
    idx = torch.from_numpy(rng1.integers(0, T, (N,)).astype(np.int32))
    results.append(gather_probe(tbl.to(device), idx.to(device), reps))

    if geo20 is None:
        geo20 = build_box(1.0, 1.0, 1.0, walk_cells, walk_cells, walk_cells,
                          device=device).geo20
    ridx = np.random.default_rng(3).integers(0, geo20.shape[0], walk_records)
    results.append(gather_probe(
        geo20, torch.from_numpy(ridx.astype(np.int32)).to(device), reps
    ))
    del ridx

    for B, ntet, G in SCATTER_SHAPES:
        r = probe_scatter_inputs(B, ntet, G, device)
        for kind in ("atomic", "ordered"):
            results.append(scatter_probe(
                kind, r["flux"], r["bin"], r["order"], r["c"],
                (B, ntet, G), reps,
            ))
    if records is None:
        ntet = geo20.shape[0]
        records = walk_stand_in(ntet * walk_groups, walk_records, device,
                                geo20.dtype)
        wshape = (walk_records, ntet, walk_groups)
    else:
        wshape = (records["bin"].numel(), records["flux"].numel() // 2)
    for kind in ("atomic", "ordered"):
        results.append(scatter_probe(
            kind, records["flux"], records["bin"], records["order"],
            records["c"], wshape, reps,
        ))
    dev_info = card() if device.type == "cuda" else {"name": "cpu"}
    return dict(device=dev_info, plain=device.type == "cpu", probes=results)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain versions only)")
    ap.add_argument("--out", default=None, help="write the JSON here")
    ap.add_argument("--walk-cells", type=int, default=WALK_CELLS)
    ap.add_argument("--walk-records", type=int, default=WALK_RECORDS)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("gather_scatter: no CUDA card; pass --device cpu to run the "
              "plain versions", file=sys.stderr)
        return 2
    payload = run(device, walk_cells=args.walk_cells,
                  walk_records=args.walk_records)
    for p in payload["probes"]:
        us = p["usec_per_call"]
        print(f"{p['probe']:16s} {str(p['shape']):28s} "
              f"{'OK ' if p['ok'] else 'FAIL'} agree={p['agree']} "
              + (f"{us:10.1f} us/call {p['gbps']:8.2f} GB/s"
                 if us is not None else "(plain: not timed)")
              + (f" {p['error']}" if p["error"] else ""))
    if args.out:
        from ..utils.checkpoint import atomic_write_json

        atomic_write_json(args.out, payload)
        print(f"wrote {args.out} ({len(payload['probes'])} probes)")
    return 0 if all(p["ok"] for p in payload["probes"]) else 1


if __name__ == "__main__":
    sys.exit(main())
