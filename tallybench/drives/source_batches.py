"""Device-sourced batches (``SyntheticTransport.run_batch``'s megastep
mode): a batch is ``initialize_particle_location`` at the batch's source
sites, then ``run_source_moves(max_events, SourceParams(seed=batch seed),
weights 1, groups 0, every lane alive)``, which runs until every lane is
dead. Batch b's source seed is ring entry ``b % len(seeds)`` of ``seeds``
seeds drawn in [0, 2^31 - 1).

Read beside the flux: ``segments``, the relative gap of the batch's scored
segments (the numerator of the cell's rate). The physics counters are not
read: they are integer sums over lanes, which only a lane whose history
parts at a degenerate point moves, by one, in sound runs and in a lower
precision alike.
"""
from __future__ import annotations

import numpy as np

from tallybench.check import DTYPES, rel
from tallybench.drive import init_walk, region_table, region_values, span
from tallybench.reference import transport

def draw(mix: dict, cfg: dict, rng) -> dict:
    return {"seeds": rng.integers(0, 2 ** 31 - 1, int(mix["seeds"]))}


def batch_seed(traffic, b: int) -> int:
    seeds = traffic.rings["seeds"]
    return int(seeds[b % len(seeds)])


def first(traffic) -> dict:
    return dict(batch=0, site=traffic.site(0), seed=batch_seed(traffic, 0),
                move0=0)


class Driver:
    def __init__(self, tally, traffic, cfg, probe):
        from pumiumtally_tpu_torch.ops.source import SourceParams

        n = int(cfg["particles"])
        self.tally, self.traffic, self.cfg, self.probe = (tally, traffic,
                                                          cfg, probe)
        self.params_cls = SourceParams
        self.weights = np.ones(n)
        self.groups = np.zeros(n, np.int32)
        self.alive = np.ones(n, bool)
        mat = cfg["materials"]
        self.physics = dict(
            default_sigma_t=float(mat["sigma_t"]),
            sigma_t=region_values(cfg, "sigma_t"),
            default_absorption=float(mat["absorption"]),
            absorption=region_values(cfg, "absorption"),
            survival_weight=float(cfg["survival_weight"]),
            downscatter=float(cfg["downscatter"]))
        self.moves = 0        # the moves the tally has run: its source keys
        self.batches = 0
        self.calls = 0
        self.last = None
        self._seq = -1

    def batch(self) -> int:
        t, tr, b = self.tally, self.traffic, self.batches
        site, seed = tr.site(b), batch_seed(tr, b)
        on = self.probe.on
        with span(on, "batch"):
            with span(on, "initialize_particle_location"):
                t.initialize_particle_location(tr.sites[site].reshape(-1))
            if on:
                w = init_walk(t.last_stats, t.num_particles)
                if w:
                    self.probe.walks.append(w)
                self._seq = _last_seq(t)
            with span(on, "run_source_moves"):
                out = t.run_source_moves(
                    int(self.cfg["max_events"]),
                    self.params_cls(seed=seed, **self.physics),
                    weights=self.weights, groups=self.groups,
                    alive=self.alive)
        if on:
            self._collect(t.num_particles)
        self.last = dict(batch=b, site=site, seed=seed, move0=self.moves,
                         out=out)
        self.moves += int(out["moves"])
        self.batches += 1
        self.calls += 2
        return int(out["segments"])

    def outputs(self) -> dict:
        return dict(self.last["out"])

    def _collect(self, lanes: int) -> None:
        """The batch's moves from the program's flight records: a move's
        lanes are those alive after the move before."""
        for rec in _records(self.tally):
            if rec["seq"] <= self._seq or rec["kind"] != "megastep":
                continue
            self.probe.walks.append(dict(
                lanes=lanes, segments=rec["segments"], initial=False,
                iters=rec["segments"] + rec["chase_hops"]))
            lanes = int(rec["alive"])
        rows = self.tally.step_clock.rows()
        waits = [r["host_ms"] for r in rows
                 if r["step"] in ("count_wait", "bucket_wait")]
        walks = sum(1 for r in rows if r["step"] == "walk")
        if walks:
            self.probe.waits.append((sum(waits) * 1e-3, walks))
            # Each fused move's steps; the waits are inside its walk step.
            steps = sum(r["host_ms"] for r in rows
                        if r["step"] not in ("count_wait", "bucket_wait"))
            self.probe.step_ms.extend([steps / walks] * walks)


def reference(tab, sites, elem, flux, *, cfg, traffic, last, dtype) -> dict:
    """The batch on the plain reference; the source's uniforms are drawn
    in the configuration's type, as the program draws them."""
    return transport.source_batch(
        tab, sites, elem, flux, seed=last["seed"], move0=last["move0"],
        n_groups=int(cfg["n_groups"]), sigma_t=region_table(cfg, "sigma_t"),
        absorption=region_table(cfg, "absorption"),
        survival_weight=float(cfg["survival_weight"]),
        downscatter=float(cfg["downscatter"]),
        max_moves=int(cfg["max_events"]), tolerance=float(cfg["tolerance"]),
        udtype=DTYPES[cfg["dtype"]])


def compare(prog: dict, ref: dict) -> dict:
    return {"segments": rel(prog["segments"], ref["segments"])}


def _records(tally) -> list:
    return tally._telemetry.recorder.records()


def _last_seq(tally) -> int:
    recs = _records(tally)
    return recs[-1]["seq"] if recs else -1
