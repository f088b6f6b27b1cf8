"""Host-side large-scale sparse parameter table.

Counterpart of ``paddle_tpu/distributed/large_scale_kv.py``, kept as a copy
(the port imports nothing of the JAX package): one sparse variable as
id -> row in host memory (numpy), rows created on first touch, updated by
the sgd, adagrad or adam rule, saved and loaded with pickle. The trainer
pulls the rows a batch touches, its step computes their gradients on the
card, and push applies the sparse rule here, on the host (the Downpour
pull/push contract).

Bitwise the JAX table: a row's initial value depends only on the table's
seed and the row's id (``(seed * 2654435761 + id * 40503) & 0x7fffffff``
seeds a ``RandomState``), duplicates in a push are summed first
(``np.unique`` + ``np.add.at``), the rules run in the same numpy order,
and the pickle layout is the same, so a table saved by either package
loads in the other. A new row reseeds one ``RandomState`` where the JAX table
builds one a row; the doubles drawn are the same
(``scripts/ps_table_rows.py`` checks it and times both).
"""
from __future__ import annotations

import os
import pickle
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class SparseTableConfig:
    name: str = "embedding"
    dim: int = 8
    initializer: str = "gaussian"   # gaussian | uniform | fill
    init_scale: float = 0.01
    fill_value: float = 0.0
    optimizer: str = "sgd"          # sgd | adagrad | adam
    lr: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    seed: int = 0


class LargeScaleKV:
    """One sparse variable: id -> row (+ per-row optimizer slots)."""

    def __init__(self, config: SparseTableConfig):
        self.cfg = config
        self._rows: Dict[int, np.ndarray] = {}
        self._slots: Dict[str, Dict[int, np.ndarray]] = {}
        self._beta_pow: Dict[int, np.ndarray] = {}
        self._lock = threading.Lock()
        self._init_rng = np.random.RandomState(0)

    # --- row init on first touch ---
    def _new_row(self, row_id: int = 0) -> np.ndarray:
        c = self.cfg
        # per-id deterministic init, not a sequential rng: the value of
        # row i does not depend on which ids were pulled before it, so
        # replicas, restarts and local or remote tables agree
        if c.initializer in ("gaussian", "uniform"):
            # one RandomState reseeded a row (the caller holds the lock):
            # the JAX table's fresh RandomState(seed).normal(0, s) and
            # .uniform(-s, s) draw the same doubles, as 0 + s * gauss and
            # -s + 2s * next_double, without a generator's set-up a row
            rng = self._init_rng
            rng.seed((c.seed * 2654435761 + row_id * 40503) & 0x7fffffff)
            if c.initializer == "gaussian":
                return (rng.standard_normal(c.dim) *
                        c.init_scale).astype(np.float32)
            lo = -c.init_scale
            return (lo + (c.init_scale - lo) *
                    rng.random_sample(c.dim)).astype(np.float32)
        return np.full(c.dim, c.fill_value, np.float32)

    # --- pull / push ------------------------------------------------------
    def pull(self, ids: np.ndarray) -> np.ndarray:
        """Rows for ids (created on miss), shape [len(ids), dim]."""
        ids = np.asarray(ids).reshape(-1)
        out = np.empty((len(ids), self.cfg.dim), np.float32)
        with self._lock:
            for i, r in enumerate(ids):
                row = self._rows.get(int(r))
                if row is None:
                    row = self._new_row(int(r))
                    self._rows[int(r)] = row
                out[i] = row
        return out

    def push(self, ids: np.ndarray, grads: np.ndarray,
             lr: Optional[float] = None):
        """Apply the configured sparse optimizer row-wise. Duplicate ids
        in a batch are merged (summed) first."""
        ids = np.asarray(ids).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(len(ids), -1)
        uniq, inv = np.unique(ids, return_inverse=True)
        merged = np.zeros((len(uniq), grads.shape[1]), np.float32)
        np.add.at(merged, inv, grads)
        lr = self.cfg.lr if lr is None else lr
        opt = self.cfg.optimizer
        with self._lock:
            for i, r in enumerate(uniq):
                r = int(r)
                row = self._rows.get(r)
                if row is None:
                    row = self._new_row(r)
                g = merged[i]
                if opt == "sgd":
                    row = row - lr * g
                elif opt == "adagrad":
                    G = self._slots.setdefault("g2", {}).get(
                        r, np.zeros_like(row))
                    G = G + g * g
                    self._slots["g2"][r] = G
                    row = row - lr * g / (np.sqrt(G) + self.cfg.epsilon)
                elif opt == "adam":
                    c = self.cfg
                    m = self._slots.setdefault("m", {}).get(
                        r, np.zeros_like(row))
                    v = self._slots.setdefault("v", {}).get(
                        r, np.zeros_like(row))
                    b = self._beta_pow.get(r, np.array([c.beta1, c.beta2],
                                                       np.float64))
                    m = c.beta1 * m + (1 - c.beta1) * g
                    v = c.beta2 * v + (1 - c.beta2) * g * g
                    lr_t = lr * np.sqrt(1 - b[1]) / (1 - b[0])
                    row = row - lr_t * m / (np.sqrt(v) + c.epsilon)
                    self._slots["m"][r], self._slots["v"][r] = m, v
                    self._beta_pow[r] = b * [c.beta1, c.beta2]
                else:
                    raise ValueError("unknown sparse optimizer %r" % opt)
                self._rows[r] = row.astype(np.float32)

    # --- introspection / persistence -------------------------------------
    def size(self) -> int:
        return len(self._rows)

    def ids(self):
        return sorted(self._rows)

    def write(self, ids: np.ndarray, values: np.ndarray):
        """Direct row assignment (``lookup_sparse_table_write``): resets
        the rows' optimizer slots too, so a written row restarts its
        history."""
        ids = np.asarray(ids).reshape(-1)
        values = np.asarray(values, np.float32).reshape(len(ids), -1)
        with self._lock:
            for i, r in enumerate(ids):
                r = int(r)
                self._rows[r] = values[i]
                for slot in self._slots.values():
                    slot.pop(r, None)
                self._beta_pow.pop(r, None)

    def save(self, dirname: str):
        os.makedirs(dirname, exist_ok=True)
        with self._lock:
            # snapshot under the lock: the server's handler threads
            # mutate _rows concurrently
            blob = pickle.dumps(
                {"cfg": self.cfg.__dict__, "rows": dict(self._rows),
                 "slots": {k: dict(v) for k, v in self._slots.items()},
                 "beta_pow": dict(self._beta_pow)}, protocol=2)
        with open(os.path.join(dirname, self.cfg.name + ".kv"),
                  "wb") as f:
            f.write(blob)

    def load(self, dirname: str):
        with open(os.path.join(dirname, self.cfg.name + ".kv"), "rb") as f:
            d = pickle.load(f)
        self._rows = d["rows"]
        self._slots = d["slots"]
        self._beta_pow = d.get("beta_pow", {})
