#!/usr/bin/env python3
"""Rows of the parameter server's host table (``paddle_tpu_torch/
distributed/large_scale_kv.py``).

1. The port's initializer (one ``RandomState`` reseeded a row) against the
   JAX table's (a fresh ``RandomState(seed).normal(0, s)`` or
   ``.uniform(-s, s)`` a row), bitwise, over ``--ids`` ids for both laws,
   dims 1, 5, 7 and 16 and three table seeds.
2. The cost of a new row each way, on this host.
3. The new rows a step of ``chip_smoke.py`` phase 15's Wide&Deep batches
   (``tests/torch_ps_runner.py`` ``ctr_batch``: 2 x 1024 rows, 26 slots,
   Zipf(1.2) ids folded into 100,000), and one pull's time each way.

Run on the CPU: ``python3 scripts/ps_table_rows.py [--ids 100000]``.
"""
import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from paddle_tpu_torch.distributed import (LargeScaleKV,  # noqa: E402
                                          SparseTableConfig)


def fresh_row(cfg, row_id):
    """The JAX table's row: a RandomState built for the row."""
    rng = np.random.RandomState(
        (cfg.seed * 2654435761 + row_id * 40503) & 0x7fffffff)
    if cfg.initializer == "gaussian":
        return rng.normal(0.0, cfg.init_scale, cfg.dim).astype(np.float32)
    return rng.uniform(-cfg.init_scale, cfg.init_scale,
                       cfg.dim).astype(np.float32)


class FreshKV(LargeScaleKV):
    def _new_row(self, row_id=0):
        return fresh_row(self.cfg, row_id)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ids", type=int, default=100000)
    args = ap.parse_args()
    checked = 0
    for law in ("gaussian", "uniform"):
        for dim in (1, 5, 7, 16):
            for seed in (0, 3, 11):
                cfg = SparseTableConfig(dim=dim, initializer=law, seed=seed,
                                        init_scale=0.1 if dim != 5 else 0.3)
                ids = np.arange(args.ids)
                got = LargeScaleKV(cfg).pull(ids)
                want = np.stack([fresh_row(cfg, int(r)) for r in ids])
                if not np.array_equal(got.view(np.uint32),
                                      want.view(np.uint32)):
                    bad = int((got.view(np.uint32) !=
                               want.view(np.uint32)).any(1).sum())
                    raise SystemExit(f"{law} dim {dim} seed {seed}: {bad} "
                                     "rows differ")
                checked += len(ids)
    print(f"rows bitwise equal to a fresh RandomState's: {checked} "
          "(2 laws x dims 1, 5, 7, 16 x seeds 0, 3, 11)")
    cfg = SparseTableConfig(dim=16, initializer="gaussian", init_scale=0.1,
                            seed=3)
    for name, kv in (("reseeded (port)", LargeScaleKV(cfg)),
                     ("fresh (JAX)", FreshKV(cfg))):
        t = time.perf_counter()
        kv.pull(np.arange(20000))
        print(f"{name}: {1e6 * (time.perf_counter() - t) / 20000:.2f} us "
              "a new row (dim 16, a pull of 20,000 new ids)")
    import torch_ps_runner as R
    full = dict(R.CTR_SMALL, vocab=100000, dim=16, slots=26, dense=13,
                b=1024, law="zipf")
    tables = {"port": LargeScaleKV(R.sparse_cfg(full)),
              "jax": FreshKV(R.sparse_cfg(full))}
    for step in range(5):
        ids = R.ctr_batch(full, step, 0, 2 * full["b"])[0].reshape(-1)
        line = []
        for name, kv in tables.items():
            n0 = kv.size()
            t = time.perf_counter()
            kv.pull(ids)
            line.append(f"{name} pull {1e3 * (time.perf_counter() - t):.1f} "
                        "ms")
        print(f"step {step + 1}: {len(ids)} ids, "
              f"{len(np.unique(ids))} unique, {kv.size() - n0} new rows; "
              + ", ".join(line))


if __name__ == "__main__":
    main()
