"""MovieLens ratings -> the NCF training pipeline: parse, leave-one-out
split, negative sampling, record writing and the HR/NDCG evaluation.

A copy of ``autodist_tpu/data/movielens.py`` (the reference's
``examples/benchmark/utils/recommendation/``: ``movielens.py`` parse,
``data_preprocessing.py`` id remap and leave-one-out split,
``stat_utils.py`` negative sampling, ``neumf_model.py`` HR/NDCG), with
the same numpy arithmetic and seeds, so one file gives the same split,
samples and batches in both packages:

- interactions are parsed once into numpy and written as fixed-shape
  ADT1 records (``data/record_dataset.py``), so training batches come
  off the native loader's worker threads;
- negative sampling is vectorized numpy with rejection against each
  user's positive set, and the residual collisions are reported;
- the eval protocol is leave-one-out HR@K / NDCG@K over sampled
  negatives, one batched forward pass a chunk.

The parser reads the ``ml-1m``/``ml-10m`` ``ratings.dat`` format
(``user::item::rating::timestamp``) and csv with a header (``ml-25m``).
The repository bundles a SYNTHETIC slice in that format
(``examples/benchmark/data/ml_tiny_synthetic.dat``); point
``load_ratings`` at a real download for the benchmark.
"""
import dataclasses
import os
from typing import Dict, Iterator, Tuple

import numpy as np

from autodist_tpu_torch.utils import logging


@dataclasses.dataclass
class RatingsData:
    """Contiguously re-indexed interactions, time-ordered per user."""
    users: np.ndarray        # int32 [n] in [0, num_users)
    items: np.ndarray        # int32 [n] in [0, num_items)
    timestamps: np.ndarray   # int64 [n]
    num_users: int
    num_items: int

    @property
    def n(self) -> int:
        return int(self.users.shape[0])


def load_ratings(path: str, min_rating: float = 0.0) -> RatingsData:
    """Parse a MovieLens ratings file and remap ids to contiguous ints
    (the reference's ``data_preprocessing.py`` categorical remap).
    ``min_rating`` drops low ratings (the implicit-feedback threshold);
    the default keeps everything, matching the NCF paper's binarization
    of *interactions*."""
    users, items, ratings, stamps = [], [], [], []
    with open(path) as f:
        first = f.readline()
        sep = "::" if "::" in first else ","
        lines = [] if first.lower().startswith("userid") else [first]
        for line in lines + f.readlines():
            line = line.strip()
            if not line:
                continue
            u, i, r, t = line.split(sep)[:4]
            users.append(int(u))
            items.append(int(i))
            ratings.append(float(r))
            stamps.append(int(t))
    users = np.asarray(users, np.int64)
    items = np.asarray(items, np.int64)
    ratings = np.asarray(ratings, np.float32)
    stamps = np.asarray(stamps, np.int64)
    if min_rating > 0:
        keep = ratings >= min_rating
        users, items, stamps = users[keep], items[keep], stamps[keep]
    uniq_u, users = np.unique(users, return_inverse=True)
    uniq_i, items = np.unique(items, return_inverse=True)
    logging.info("movielens: %d interactions, %d users, %d items (%s)",
                 len(users), len(uniq_u), len(uniq_i), os.path.basename(path))
    return RatingsData(users=users.astype(np.int32),
                       items=items.astype(np.int32),
                       timestamps=stamps, num_users=len(uniq_u),
                       num_items=len(uniq_i))


def leave_one_out_split(data: RatingsData
                        ) -> Tuple[RatingsData, Dict[int, int]]:
    """The NCF paper's protocol (reference ``data_preprocessing.py``):
    each user's LATEST interaction is held out for evaluation; everything
    else trains. Returns (train split, {user: held-out item})."""
    order = np.lexsort((data.timestamps, data.users))
    u_sorted = data.users[order]
    # last row of each user's time-sorted run = their latest interaction
    is_last = np.r_[u_sorted[1:] != u_sorted[:-1], True]
    test_rows = order[is_last]
    train_rows = order[~is_last]
    holdout = {int(data.users[r]): int(data.items[r]) for r in test_rows}
    train = RatingsData(users=data.users[train_rows],
                        items=data.items[train_rows],
                        timestamps=data.timestamps[train_rows],
                        num_users=data.num_users, num_items=data.num_items)
    return train, holdout


def write_train_records(data: RatingsData, path: str) -> str:
    """Materialize the positive interactions as an ADT1 record file so the
    native loader (C++ worker threads) assembles training batches."""
    from autodist_tpu_torch.data.record_dataset import RecordFileWriter
    with RecordFileWriter(path, fields=[("user", np.int32, ()),
                                        ("item", np.int32, ())]) as w:
        w.write_batch({"user": data.users, "item": data.items})
    return path


class NegativeSampler:
    """Vectorized negative sampling with rejection against each user's
    positive set. One call maps a batch of positive (user, item) pairs to
    the full NCF batch: each positive plus ``neg_per_pos`` sampled
    negatives, labels 1/0."""

    def __init__(self, data: RatingsData, neg_per_pos: int = 4,
                 rounds: int = 4, seed: int = 0):
        self._num_items = data.num_items
        self._neg = neg_per_pos
        self._rounds = rounds
        self._rng = np.random.RandomState(seed)
        # one sorted array of composite (user, item) keys: membership for
        # a whole batch is a single vectorized searchsorted — the data
        # path must never loop in Python per element
        self._keys = np.sort(data.users.astype(np.int64) * data.num_items
                             + data.items)
        self.false_negatives = 0  # residual collisions after all rounds

    def _is_positive(self, users: np.ndarray, items: np.ndarray) -> np.ndarray:
        if not len(self._keys):
            return np.zeros(users.shape, bool)
        keys = users.astype(np.int64) * self._num_items + items
        pos = np.searchsorted(self._keys, keys)
        pos = np.minimum(pos, len(self._keys) - 1)
        return self._keys[pos] == keys

    def batch(self, users: np.ndarray, items: np.ndarray
              ) -> Dict[str, np.ndarray]:
        n = users.shape[0]
        neg_u = np.repeat(users, self._neg)
        neg_i = self._rng.randint(0, self._num_items, neg_u.shape[0])
        for _ in range(self._rounds):
            bad = self._is_positive(neg_u, neg_i)
            if not bad.any():
                break
            neg_i[bad] = self._rng.randint(0, self._num_items,
                                           int(bad.sum()))
        else:
            self.false_negatives += int(self._is_positive(neg_u, neg_i).sum())
        return {
            "user": np.concatenate([users, neg_u]).astype(np.int32),
            "item": np.concatenate([items, neg_i]).astype(np.int32),
            "label": np.concatenate([np.ones(n, np.int32),
                                     np.zeros(neg_u.shape[0], np.int32)]),
        }


def train_batches(record_path: str, data: RatingsData, pos_per_batch: int,
                  neg_per_pos: int = 4, seed: int = 0,
                  num_threads: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite NCF batch stream: positives off the NATIVE record loader,
    negatives sampled per batch. Batch size = pos_per_batch x
    (1 + neg_per_pos)."""
    from autodist_tpu_torch.data.record_dataset import RecordFileDataset
    sampler = NegativeSampler(data, neg_per_pos=neg_per_pos, seed=seed)
    ds = RecordFileDataset(record_path, batch_size=pos_per_batch,
                           shuffle=True, seed=seed, num_threads=num_threads)
    try:
        for batch in ds:
            yield sampler.batch(batch["user"], batch["item"])
    finally:
        ds.close()  # abandoned iterators must not leak native threads


def evaluate_hit_ndcg(score_fn, holdout: Dict[int, int], data: RatingsData,
                      num_negatives: int = 99, k: int = 10,
                      seed: int = 0, chunk: int = 256) -> Dict[str, float]:
    """Leave-one-out HR@K / NDCG@K (reference
    ``neumf_model.py:compute_eval_loss_and_metrics``): for each user,
    rank the held-out item against ``num_negatives`` sampled unseen
    items; HR = fraction of users whose held-out item ranks in the top K,
    NDCG discounts by log2(rank+1). ``score_fn(users, items) -> scores``
    is one batched forward pass."""
    rng = np.random.RandomState(seed)
    sampler = NegativeSampler(data, neg_per_pos=num_negatives,
                              seed=seed + 1)
    users = np.asarray(sorted(holdout), np.int32)
    hits, ndcg, false_neg = 0.0, 0.0, 0
    for c0 in range(0, len(users), chunk):
        u = users[c0:c0 + chunk]
        pos = np.asarray([holdout[int(x)] for x in u], np.int32)
        neg_u = np.repeat(u, num_negatives)
        neg_i = rng.randint(0, data.num_items, neg_u.shape[0])
        for _ in range(4):  # negatives must be unseen AND not the held-out
            bad = sampler._is_positive(neg_u, neg_i) | (
                neg_i == np.repeat(pos, num_negatives))
            if not bad.any():
                break
            neg_i[bad] = rng.randint(0, data.num_items, int(bad.sum()))
        else:
            # residual collisions are REPORTED, never silently accepted
            false_neg += int((sampler._is_positive(neg_u, neg_i) | (
                neg_i == np.repeat(pos, num_negatives))).sum())
        all_u = np.concatenate([u, neg_u])
        all_i = np.concatenate([pos, neg_i])
        scores = np.asarray(score_fn(all_u, all_i), np.float32)
        pos_s = scores[:len(u)]
        neg_s = scores[len(u):].reshape(len(u), num_negatives)
        rank = (neg_s > pos_s[:, None]).sum(axis=1)  # 0-based rank
        hits += float((rank < k).sum())
        ndcg += float((np.log(2.0) / np.log(rank + 2.0))[rank < k].sum())
    n = float(len(users))
    return {"hr": hits / n, "ndcg": ndcg / n, "users": int(n),
            "false_negatives": false_neg}
