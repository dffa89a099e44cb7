"""DIN sequence data: Amazon-Electronics-style behavior histories.

The reference trains DIN from pre-built TFRecords (``train2``/``valid2``,
din/din.py:197-198) whose construction isn't in the repo; the README
describes the protocol (README.md:92-106): per-user chronological item
history, predict the next item, negatives sampled globally at random (the
noted AUC caveat), item + category id per event.

Static-shape design: variable-length histories (VarLenFeature densification,
din/din.py:48-57) become *bucketed fixed-length padding* — each batch pads
to the smallest configured bucket ≥ its longest history, so XLA sees a few
static shapes instead of per-batch dynamic ones (SURVEY §5.7). Padding id is
0, masked in the attention (din/din.py:107); real ids start at 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DEFAULT_BUCKETS = (8, 16, 32, 64, 128)


@dataclass
class DinDataset:
    """Fixed-width example arrays ready for batching."""

    i_id: np.ndarray       # [N] target item (1-based)
    i_cate: np.ndarray     # [N]
    hist_iid: np.ndarray   # [N, P] 0-padded
    hist_cate: np.ndarray  # [N, P]
    label: np.ndarray      # [N]
    item_vocab: int        # includes the 0 padding id
    cate_vocab: int


def pad_to_bucket(lengths: np.ndarray,
                  buckets: tuple[int, ...] = DEFAULT_BUCKETS) -> int:
    m = int(lengths.max()) if len(lengths) else 1
    for b in buckets:
        if m <= b:
            return b
    return m


def build_examples(
    user_histories: list[list[tuple[int, int]]],
    *,
    item_vocab: int,
    cate_vocab: int,
    item_to_cate: np.ndarray,
    max_hist: int = 128,
    seed: int = 0,
    buckets: tuple[int, ...] = DEFAULT_BUCKETS,
    hard_neg: float = 0.0,
    neg_pools: list | None = None,
) -> DinDataset:
    """Per-user (item, cate) event lists → pos/neg next-item examples.

    For every user with ≥2 events: history = events[:-1], positive target =
    events[-1], negative target = uniform random item (the reference's
    global negative sampling, README.md:106). With ``hard_neg > 0`` a
    fraction of negatives draw from ``neg_pools[u]`` (the user's favored
    item pool) instead — see `synthetic_din`.
    """
    rng = np.random.default_rng(seed)
    tgt_i, tgt_c, labels, hists = [], [], [], []
    for u, events in enumerate(user_histories):
        if len(events) < 2:
            continue
        hist = events[:-1][-max_hist:]
        pos_i, pos_c = events[-1]
        tgt_i.append(pos_i)
        tgt_c.append(pos_c)
        labels.append(1.0)
        hists.append(hist)
        pool = neg_pools[u] if neg_pools is not None else None
        if pool is not None and len(pool) and rng.random() < hard_neg:
            neg_i = int(rng.choice(pool))
        else:
            neg_i = int(rng.integers(1, item_vocab))
        tgt_i.append(neg_i)
        tgt_c.append(int(item_to_cate[neg_i]))
        labels.append(0.0)
        hists.append(hist)

    n = len(tgt_i)
    lengths = np.asarray([len(h) for h in hists], np.int32)
    p = pad_to_bucket(lengths, buckets)
    hist_iid = np.zeros((n, p), np.int32)
    hist_cate = np.zeros((n, p), np.int32)
    for i, h in enumerate(hists):
        if h:
            arr = np.asarray(h, np.int32)
            hist_iid[i, :len(h)] = arr[:, 0]
            hist_cate[i, :len(h)] = arr[:, 1]
    return DinDataset(
        np.asarray(tgt_i, np.int32), np.asarray(tgt_c, np.int32),
        hist_iid, hist_cate, np.asarray(labels, np.float32),
        item_vocab, cate_vocab,
    )


def synthetic_din(
    n_users: int = 500, item_vocab: int = 400, cate_vocab: int = 20,
    seed: int = 0, mean_hist: int = 12, noise: float = 0.0,
    hard_neg: float = 0.0,
) -> DinDataset:
    """Planted taste clusters: each user favors one category; their history
    and true next item come from it. A model attending to history beats
    random easily — the learnability floor for tests.

    Two hardness knobs (the default regression task uses noise=0.25,
    hard_neg=0.35 via `synthetic_din_hard` — a clean task saturates at
    AUC 0.99 and says nothing about regressions):

    - ``noise``: probability that a history event is drawn from a random
      category instead of the user's (taste impurity — the attention must
      aggregate over a corrupted history);
    - ``hard_neg``: fraction of negative targets sampled from the USER'S
      OWN favored category instead of globally — those negatives carry the
      same category-level signal as the positive, capping the planted
      ceiling at ≈ 1 − hard_neg/2 and forcing the model to rank on more
      than category identity.
    """
    rng = np.random.default_rng(seed)
    item_to_cate = np.concatenate(
        [[0], rng.integers(1, cate_vocab, item_vocab - 1)]
    )
    cate_items = {
        c: np.where(item_to_cate == c)[0]
        for c in range(1, cate_vocab)
    }
    histories = []
    fav_cates = []
    for _ in range(n_users):
        c = int(rng.integers(1, cate_vocab))
        pool = cate_items.get(c)
        if pool is None or len(pool) == 0:
            continue
        length = max(2, int(rng.poisson(mean_hist)))
        items = rng.choice(pool, size=length, replace=True)
        if noise > 0.0:
            flip = rng.random(length) < noise
            items = np.where(flip,
                             rng.integers(1, item_vocab, length), items)
            # the true next item stays on-taste (events[-1] is the positive)
            items[-1] = int(rng.choice(pool))
        histories.append([(int(i), int(item_to_cate[i])) for i in items])
        fav_cates.append(c)
    neg_pools = ([cate_items.get(c) for c in fav_cates]
                 if hard_neg > 0.0 else None)
    return build_examples(
        histories, item_vocab=item_vocab, cate_vocab=cate_vocab,
        item_to_cate=item_to_cate, seed=seed + 1,
        hard_neg=hard_neg, neg_pools=neg_pools,
    )


def synthetic_din_hard(
    n_users: int = 500, item_vocab: int = 400, cate_vocab: int = 20,
    seed: int = 0, mean_hist: int = 12,
) -> DinDataset:
    """The hardened regression task (see synthetic_din): noisy histories +
    in-category negatives. The planted ceiling on category signal alone is
    ≈ (1−hard_neg)·1 + hard_neg·0.5 ≈ 0.875; trained DIN lands ≈ 0.80-0.85
    depending on data volume (calibrated on CPU: noise 0.25/hard_neg 0.35
    trained to 0.76 vs its 0.81 ceiling — this setting keeps the task
    non-saturating but above the noise floor). A regression that once
    cleared 0.99 on the clean task now has ~0.1 AUC of headroom to lose."""
    return synthetic_din(n_users, item_vocab, cate_vocab, seed, mean_hist,
                         noise=0.2, hard_neg=0.25)


def save_din_npz(ds: DinDataset, path: str) -> str:
    """Persist a DinDataset (the offline L0 artifact for tools/train_din)."""
    np.savez(path, i_id=ds.i_id, i_cate=ds.i_cate, hist_iid=ds.hist_iid,
             hist_cate=ds.hist_cate, label=ds.label,
             vocabs=np.asarray([ds.item_vocab, ds.cate_vocab], np.int64))
    return path


def load_din_npz(path: str) -> DinDataset:
    with np.load(path) as z:
        return DinDataset(
            z["i_id"], z["i_cate"], z["hist_iid"], z["hist_cate"],
            z["label"], int(z["vocabs"][0]), int(z["vocabs"][1]),
        )


def batches(ds: DinDataset, batch_size: int, *, shuffle: bool = True,
            seed: int = 0, num_epochs: int = -1):
    """Batch iterator over a DinDataset (drop remainder, static shapes)."""
    n = len(ds.label)
    epoch = 0
    while num_epochs < 0 or epoch < num_epochs:
        rng = np.random.default_rng([seed, epoch])
        order = rng.permutation(n) if shuffle else np.arange(n)
        for lo in range(0, n - batch_size + 1, batch_size):
            idx = order[lo:lo + batch_size]
            yield {
                "i_id": ds.i_id[idx], "i_cate": ds.i_cate[idx],
                "hist_iid": ds.hist_iid[idx], "hist_cate": ds.hist_cate[idx],
                "label": ds.label[idx],
            }
        epoch += 1
