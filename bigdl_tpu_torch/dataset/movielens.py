"""MovieLens-1M loader and NCF-style evaluation pairs (counterpart of
``bigdl_tpu/dataset/movielens.py``; the reference's
``pyspark/bigdl/dataset/movielens.py`` ``read_data_sets`` /
``get_id_pairs`` / ``get_id_ratings`` over ``ml-1m/ratings.dat``).

Host numpy, the port's own copy. Nothing is downloaded: without an
extracted ``ml-1m`` folder (or a ``ratings.dat``) on disk, a deterministic
synthetic interaction matrix with the same column layout
(user::movie::rating::timestamp, 1-based ids) stands in, bit for bit the
JAX package's for the same arguments.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["synthetic", "read_data_sets", "get_id_pairs", "get_id_ratings",
           "train_test_split_leave_one_out"]


def synthetic(n_users=200, n_items=120, n_ratings=8000, seed=0):
    """Deterministic synthetic ratings with a low-rank structure so models
    can actually learn preferences. Returns int array (N, 4):
    user, item (1-based), rating 1-5, timestamp."""
    rng = np.random.RandomState(seed)
    # latent affinities → ratings correlate with user/item factors
    uf = rng.randn(n_users, 4)
    vf = rng.randn(n_items, 4)
    users = rng.randint(0, n_users, size=n_ratings)
    items = rng.randint(0, n_items, size=n_ratings)
    aff = np.sum(uf[users] * vf[items], axis=1)
    ratings = np.clip(np.round(3 + aff), 1, 5).astype(np.int64)
    ts = rng.randint(10 ** 8, 10 ** 9, size=n_ratings)
    data = np.stack([users + 1, items + 1, ratings, ts], axis=1).astype(np.int64)
    # dedupe (user, item)
    _, idx = np.unique(data[:, 0] * (n_items + 1) + data[:, 1],
                       return_index=True)
    return data[np.sort(idx)]


def read_data_sets(data_dir=None, n_synthetic=8000):
    """Return int ndarray (N, 4): user, item, rating, timestamp (1-based ids).
    Reads ``<data_dir>/ml-1m/ratings.dat`` (``::``-separated) when present
    and otherwise returns the synthetic matrix (nothing is downloaded)."""
    if data_dir:
        for cand in (os.path.join(data_dir, "ml-1m", "ratings.dat"),
                     os.path.join(data_dir, "ratings.dat")):
            if os.path.exists(cand):
                with open(cand) as f:
                    rows = [line.strip().split("::") for line in f
                            if line.strip()]
                return np.array(rows).astype(np.int64)
    return synthetic(n_ratings=n_synthetic)


def get_id_pairs(data_dir=None, **kw):
    return read_data_sets(data_dir, **kw)[:, 0:2]


def get_id_ratings(data_dir=None, **kw):
    return read_data_sets(data_dir, **kw)[:, 0:3]


def train_test_split_leave_one_out(data, n_negatives=4, n_eval_negatives=19,
                                   seed=0):
    """Leave-one-out split used by NCF-style HitRatio/NDCG evaluation: each
    user's last interaction (by timestamp) is held out; training pairs get
    ``n_negatives`` sampled unseen items each (label 0 vs 1); the eval list
    per user is [positive] + ``n_eval_negatives`` unseen items.

    Returns ``(train_uip, train_labels, eval_users, eval_items)`` where
    ``eval_items[u]`` has the positive at position 0.
    """
    rng = np.random.RandomState(seed)
    data = np.asarray(data)
    n_items = int(data[:, 1].max())
    seen = {}
    for u, i in data[:, :2]:
        seen.setdefault(int(u), set()).add(int(i))
    order = np.argsort(data[:, 3] if data.shape[1] > 3 else
                       np.arange(len(data)), kind="stable")
    last = {}
    for idx in order:
        last[int(data[idx, 0])] = int(data[idx, 1])

    all_items = np.arange(1, n_items + 1)
    unseen_of = {}

    def sample_neg(u, k):
        # without replacement from the user's unseen set; when the user has
        # seen (almost) everything, fall back to uniform seen-or-not draws so
        # this always terminates. The unseen set is computed once a user
        # (the JAX package recomputes it every draw; the draws are the same)
        unseen = unseen_of.get(u)
        if unseen is None:
            unseen = unseen_of[u] = np.setdiff1d(
                all_items, np.fromiter(seen[u], np.int64),
                assume_unique=False)
        if len(unseen) >= k:
            return rng.choice(unseen, size=k, replace=False).tolist()
        if len(unseen) > 0:
            return rng.choice(unseen, size=k, replace=True).tolist()
        return rng.choice(all_items, size=k, replace=True).tolist()

    tr_u, tr_i, tr_y = [], [], []
    ev_u, ev_items = [], []
    for u, s in seen.items():
        holdout = last[u]
        for i in s:
            if i == holdout:
                continue  # never leak the eval positive into training
            tr_u.append(u); tr_i.append(i); tr_y.append(1)
            for neg in sample_neg(u, n_negatives):
                tr_u.append(u); tr_i.append(neg); tr_y.append(0)
        ev_u.append(u)
        ev_items.append([holdout] + sample_neg(u, n_eval_negatives))
    train = np.stack([tr_u, tr_i], axis=1).astype(np.int64)
    return (train, np.asarray(tr_y, np.int64),
            np.asarray(ev_u, np.int64), np.asarray(ev_items, np.int64))
