"""FTRL-proximal sparse logistic regression (ftrl/ftrl.py:54-181).

Re-design of the reference's pure-python per-feature loops as numpy
vector ops over fixed-width hashed index rows:

- hash trick D=2^20 over "column_value" strings with a bias term at index 0
  (ftrl/ftrl.py:41,214-241);
- optional poly2 interactions (ftrl/ftrl.py:99-107);
- lazy-weight prediction: w built on the fly from (z, n) with L1/L2
  (ftrl/ftrl.py:109-151), bounded sigmoid ±35 (ftrl/ftrl.py:151);
- per-example z/n update: σ = (√(n+g²) − √n)/α, z += g − σ·w, n += g²
  (ftrl/ftrl.py:153-181) — `fit_stream` keeps exact one-example-at-a-time
  semantics (online learning), vectorized across the features of a row;
- date-based holdout validation with bounded logloss (ftrl/ftrl.py:184-196,
  268-277) and a Kaggle-style submission writer (ftrl/ftrl.py:290-294).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field
from math import exp, log, sqrt

import numpy as np

from recsys.data import hashing


def bounded_logloss(p: float, y: float) -> float:
    p = max(min(p, 1.0 - 1e-14), 1e-14)
    return -log(p) if y == 1.0 else -log(1.0 - p)


@dataclass
class FtrlProximal:
    alpha: float = 0.1
    beta: float = 1.0
    l1: float = 1.0
    l2: float = 1.0
    D: int = 2 ** 20
    interaction: bool = False
    n: np.ndarray = field(default=None)
    z: np.ndarray = field(default=None)

    def __post_init__(self):
        if self.n is None:
            self.n = np.zeros(self.D, np.float64)
        if self.z is None:
            self.z = np.zeros(self.D, np.float64)

    def _indices(self, x: np.ndarray) -> np.ndarray:
        """Row indices incl. bias 0 and optional poly2 (ftrl/ftrl.py:76-107)."""
        idx = [0] + list(x)
        if self.interaction:
            xs = sorted(x)
            L = len(xs)
            for i in range(L):
                for j in range(i + 1, L):
                    idx.append(
                        hashing.hash_bucket(f"{xs[i]}_{xs[j]}", self.D)
                    )
        return np.asarray(idx, np.int64)

    def _lazy_weights(self, idx: np.ndarray) -> np.ndarray:
        z = self.z[idx]
        n = self.n[idx]
        sign = np.where(z < 0, -1.0, 1.0)
        w = (sign * self.l1 - z) / (
            (self.beta + np.sqrt(n)) / self.alpha + self.l2
        )
        return np.where(sign * z <= self.l1, 0.0, w)

    def predict_row(self, x: np.ndarray) -> tuple[float, np.ndarray, np.ndarray]:
        idx = self._indices(x)
        w = self._lazy_weights(idx)
        wtx = float(w.sum())
        p = 1.0 / (1.0 + exp(-max(min(wtx, 35.0), -35.0)))
        return p, idx, w

    def update_row(self, idx: np.ndarray, w: np.ndarray, p: float, y: float):
        g = p - y
        n = self.n[idx]
        sigma = (np.sqrt(n + g * g) - np.sqrt(n)) / self.alpha
        np.add.at(self.z, idx, g - sigma * w)
        np.add.at(self.n, idx, g * g)

    def predict(self, x: np.ndarray) -> float:
        return self.predict_row(x)[0]

    def fit_stream(self, rows, holdout_pred=None):
        """Exact online pass: predict-then-update per example
        (ftrl/ftrl.py:254-281). ``rows`` yields (x_indices, y, is_holdout).
        Returns (held-out logloss, count)."""
        loss, count = 0.0, 0
        for x, y, is_holdout in rows:
            p, idx, w = self.predict_row(np.asarray(x))
            if is_holdout:
                loss += bounded_logloss(p, y)
                count += 1
                if holdout_pred is not None:
                    holdout_pred.append(p)
            else:
                self.update_row(idx, w, p, y)
        return (loss / count if count else float("nan")), count


def hash_csv_row(row: dict, D: int, drop: tuple[str, ...] = ("id", "click"),
                 date_field: str = "hour") -> tuple[list[int], float, int]:
    """One CSV dict row → (hashed indices, label, date) — the reference's
    ``data()`` generator (ftrl/ftrl.py:199-241): 'column_value' hash per
    field, label from 'click', date parsed from the hour column YYMMDDHH."""
    y = float(row.get("click", 0))
    date = 0
    x = []
    for k, v in row.items():
        if k in drop:
            continue
        if k == date_field and len(v) >= 6:
            date = int(v[4:6])
            v = v[6:]  # keep the hour-of-day as the feature value
        x.append(hashing.hash_bucket(f"{k}_{v}", D))
    return x, y, date


def train_csv(
    train_path: str,
    *,
    epochs: int = 1,
    holdafter: int | None = 9,
    alpha: float = 0.1, beta: float = 1.0, l1: float = 1.0, l2: float = 1.0,
    D: int = 2 ** 20, interaction: bool = False,
) -> tuple[FtrlProximal, float]:
    """The reference's main loop (ftrl/ftrl.py:248-284): examples after date
    ``holdafter`` are evaluated, earlier ones train."""
    learner = FtrlProximal(alpha, beta, l1, l2, D, interaction)
    val_loss = float("nan")
    for _ in range(epochs):
        def rows():
            with open(train_path) as f:
                for row in csv.DictReader(f):
                    x, y, date = hash_csv_row(row, D)
                    is_holdout = holdafter is not None and date > holdafter
                    yield x, y, is_holdout

        val_loss, _ = learner.fit_stream(rows())
    return learner, val_loss


def write_submission(learner: FtrlProximal, test_path: str, out_path: str,
                     D: int | None = None):
    """Kaggle submission CSV (ftrl/ftrl.py:290-294)."""
    D = D or learner.D
    with open(test_path) as f, open(out_path, "w") as out:
        out.write("id,click\n")
        for row in csv.DictReader(f):
            x, _, _ = hash_csv_row(row, D)
            p = learner.predict(np.asarray(x))
            out.write(f"{row['id']},{p:.6f}\n")
