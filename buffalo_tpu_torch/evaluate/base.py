"""Ranking and score evaluation mixin (vectorized).

Behavioral counterpart of the reference ``buffalo/evaluate/base.py``:
``get_validation_results`` returns NDCG / MAP / accuracy(hit-rate) /
AUC over seen-filtered top-k recommendations plus RMSE / MAE on the
validation triples, with identical formulas (``evaluate/base.py:44-148``
— AUC via the closed form over the ranked list, idcg normalized by
``min(|gt|, topk)``, AP normalized by ``min(|gt|, topk)``).

The implementation is different by design: the reference walks a
per-user Python loop over each recommendation list; here the whole
batch is evaluated with numpy array ops — membership tests against
sorted ``(user, item)`` key arrays, a cumsum-based seen-filter
compaction, and closed-form per-batch metric reductions.  Scoring runs
on the model's device (one ``torch.matmul`` + ``torch.topk`` instead of
the C++ quickselect).  A copy of ``buffalo_tpu.evaluate.base`` for the
PyTorch port.
"""
from __future__ import annotations

import numpy as np

from buffalo_tpu_torch.ops.topk import topk as _topk_op


def _membership(sorted_keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Vectorized ``queries[i] in sorted_keys`` via binary search."""
    if sorted_keys.size == 0:
        return np.zeros(queries.shape, dtype=bool)
    pos = np.searchsorted(sorted_keys, queries)
    pos_c = np.minimum(pos, sorted_keys.size - 1)
    return (pos < sorted_keys.size) & (sorted_keys[pos_c] == queries)


class Evaluable:
    def __init__(self, *args, **kwargs):
        pass

    def prepare_evaluation(self):
        if not self.opt.get("validation") or not self.data.has_group("vali"):
            return
        if not hasattr(self.data, "vali_data"):
            self.data._prepare_validation_data()

    def show_validation_results(self):
        results = self.get_validation_results()
        if not results:
            return "No validation results"
        return "Validation results: " + ", ".join(
            f"{k}: {v:0.5f}" for k, v in results.items())

    def get_validation_results(self):
        if not self.opt.get("validation") or not self.data.has_group("vali"):
            return
        results = {}
        results.update(self._evaluate_ranking_metrics())
        results.update(self._evaluate_score_metrics())
        return results

    def get_topk(self, scores, k, sorted=True, num_threads=4):
        return _topk_op(scores, k, sorted=sorted, num_threads=num_threads,
                        device=self.device)

    # ------------------------------------------------------------- ranking
    def _ranking_arrays(self):
        """Array views of the validation dicts, built once and cached.

        Returns (users, gt_sizes, seen_sizes, gt_keys, seen_keys) where
        the key arrays hold sorted ``user * num_items + item`` composite
        keys for O(log n) vectorized membership tests.
        """
        vali = self.data.vali_data
        cached = vali.get("_vectorized")
        if cached is not None:
            return cached
        num_items = self.data.get_header()["num_items"]
        users = np.asarray(vali["vali_rows"], dtype=np.int64)

        def flatten(per_user_sets):
            sizes = np.array([len(per_user_sets.get(int(u), ()))
                              for u in users], dtype=np.int64)
            keys = np.concatenate(
                [np.fromiter(per_user_sets.get(int(u), ()), dtype=np.int64,
                             count=int(n)) + u * num_items
                 for u, n in zip(users, sizes)]) if sizes.sum() else \
                np.empty(0, dtype=np.int64)
            keys.sort()
            return sizes, keys

        gt_sizes, gt_keys = flatten(vali["vali_gt"])
        seen_sizes, seen_keys = flatten(vali["validation_seen"])
        cached = (users, gt_sizes, seen_sizes, gt_keys, seen_keys)
        vali["_vectorized"] = cached
        return cached

    def _evaluate_ranking_metrics(self):
        if not hasattr(self.data, "vali_data"):
            self.prepare_evaluation()
        # one scoring call per batch, so the default batch is much
        # larger than the reference's 128; "batch" still overrides
        batch_size = self.opt.validation.get("batch", 1024)
        topk = self.opt.validation.topk
        num_items = self.data.get_header()["num_items"]
        max_seen = self.data.vali_data["validation_max_seen_size"]

        users, gt_sizes, seen_sizes, gt_keys, seen_keys = \
            self._ranking_arrays()
        # users with nothing seen are excluded, as in the reference
        active = seen_sizes > 0
        rows = users[active]
        gt_n_all = gt_sizes[active]
        if self.opt.validation.get("eval_samples"):
            size = min(self.opt.validation.eval_samples, len(rows))
            pick = np.random.choice(len(rows), size=size, replace=False)
            rows, gt_n_all = rows[pick], gt_n_all[pick]

        dcg_w = 1.0 / np.log2(np.arange(2, topk + 2))
        idcg_table = np.cumsum(dcg_w)
        rank_inv = 1.0 / np.arange(1, topk + 1)

        totals = np.zeros(4)  # ndcg, ap, hit, auc
        n_users = 0
        for beg in range(0, len(rows), batch_size):
            batch = rows[beg:beg + batch_size]
            gt_n = gt_n_all[beg:beg + batch_size].astype(np.float64)
            pairs = list(self._get_topk_recommendation(
                batch, topk=topk + max_seen))
            b_rows = np.array([r for r, _ in pairs], dtype=np.int64)
            recs = np.vstack([np.asarray(t) for _, t in pairs])

            # drop already-seen items, keep the first `topk` survivors
            seen = _membership(seen_keys,
                               b_rows[:, None] * num_items + recs)
            rank = np.cumsum(~seen, axis=1)
            kept = ~seen & (rank <= topk)
            filtered = np.full((len(b_rows), topk), -1, dtype=np.int64)
            fi, fj = np.nonzero(kept)
            filtered[fi, rank[fi, fj] - 1] = recs[fi, fj]

            valid = filtered >= 0
            keys = np.where(valid, b_rows[:, None] * num_items + filtered, -1)
            hit = _membership(gt_keys, keys) & valid
            miss = valid & ~hit

            hits = hit.sum(axis=1)
            misses = miss.sum(axis=1)
            cum_hits = np.cumsum(hit, axis=1)
            denom = np.minimum(gt_n, topk)

            ndcg = (hit @ dcg_w) / idcg_table[denom.astype(np.int64) - 1]
            ap = ((hit * cum_hits) @ rank_inv) / denom
            acc = hits / gt_n
            # AUC closed form: hits-so-far credited at each miss, plus
            # the average rank credit for everything past the list
            neg_n = num_items - gt_n
            auc = ((miss * (cum_hits - hit)).sum(axis=1)
                   + (hits + gt_n) / 2.0 * (neg_n - misses))
            auc = auc / (gt_n * neg_n)

            totals += [ndcg.sum(), ap.sum(), acc.sum(), auc.sum()]
            n_users += len(b_rows)

        if n_users == 0:
            return {"ndcg": 0.0, "map": 0.0, "accuracy": 0.0, "auc": 0.0}
        ndcg, ap, acc, auc = totals / n_users
        return {"ndcg": ndcg, "map": ap, "accuracy": acc, "auc": auc}

    # --------------------------------------------------------------- scores
    def _evaluate_score_metrics(self):
        if not hasattr(self.data, "vali_data"):
            self.prepare_evaluation()
        vali = self.data.vali_data
        predicted = np.asarray(
            self._get_scores(vali["row"], vali["col"]), dtype=np.float64)
        err = predicted - np.asarray(vali["val"], dtype=np.float64)
        return {"rmse": float(np.sqrt(np.mean(err * err))),
                "error": float(np.mean(np.abs(err)))}
