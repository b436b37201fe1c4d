"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and a configuration, drawn from ``--seed`` into rings at set-up.

Every mix draws ``source_sites`` arrays of one source site a lane, uniform
over the mix's ``site_box`` (``[low corner, high corner]``; equal corners
make a point source); batch b starts from ring entry ``b % source_sites``.
Then the mix's drive (``drives/<drive>.py``) draws its own rings from the
same generator. Every seed gives the same sizes and the same counts; only
the draws differ.
"""
from __future__ import annotations

import numpy as np


class Traffic:
    def __init__(self, mix: dict, cfg: dict, seed: int, drive):
        rng = np.random.default_rng(int(seed) % 2 ** 64)
        n = int(cfg["particles"])
        lo, hi = (np.asarray(c, np.float64) for c in mix["site_box"])
        self.mix = mix
        self.sites = [rng.uniform(lo, hi, (n, 3))
                      for _ in range(int(mix["source_sites"]))]
        self.rings = drive.draw(mix, cfg, rng)

    def site(self, b: int) -> int:
        return b % len(self.sites)
