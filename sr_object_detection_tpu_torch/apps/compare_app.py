"""compare.c's evaluation/ranking modes: validate_compare
(compare.c:83-146), SortMaster3000 (:228-262) and the elo tournament
BattleRoyaleWithCheese (:264-341).

Counterpart of ``sr_object_detection_tpu/apps/compare_app.py``. The
reference runs ONE batch-1 forward per pairwise comparison. The
tournament's fights within a round are independent, so every round's
fights run as ONE batched forward of 6-channel pairs on ``device``
(CUDA unless the CLI's -cpu). The comparator SORT is inherently
sequential (each comparison depends on the previous ordering decision),
so it keeps the reference's one-at-a-time semantics. The shuffles draw
from ``np.random.default_rng(0)`` as the JAX module's do.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from .cli import find_value
from .misc_train import (_read_list, _load_resized, load_compare_labels,
                         SECRET_NUM)


class CompareModel:
    """6-channel pair scorer on ``device`` with an in-memory image cache
    (tournament images are revisited across rounds)."""

    def __init__(self, cfg: str, weights, *, device="cuda"):
        from .misc_apps import _load
        self.spec, self.net, self._predict = _load(cfg, weights, device)
        self._cache: dict[str, np.ndarray] = {}

    def image(self, path: str) -> np.ndarray:
        if path not in self._cache:
            self._cache[path] = _load_resized(
                path, self.spec.net.w, self.spec.net.h)
        return self._cache[path]

    def predict_pairs(self, pairs) -> np.ndarray:
        """One batched forward over [(path_a, path_b), ...] ->
        (len(pairs), 2*classes) scores."""
        x = np.stack([np.concatenate([self.image(a), self.image(b)],
                                     axis=-1) for a, b in pairs])
        out = self._predict(x)
        return out.reshape(out.shape[0], -1)


def validate_compare(cfg: str, weights, argv, *, device="cuda"):
    """validate_compare (compare.c:83-146): consecutive path pairs from
    the val list; a class slot pair counts when the truth differs, and
    is correct when the predicted order matches the truth order. The
    reference streams in 10 splits with a prefetch thread; here each
    split is one batched forward."""
    list_path = find_value(argv, "-list", "data/compare.val.list")
    classes = find_value(argv, "-classes", 20, int)
    model = CompareModel(cfg, weights, device=device)
    paths = _read_list(list_path)
    n_pairs = len(paths) // 2
    pairs = [(paths[2 * i], paths[2 * i + 1]) for i in range(n_pairs)]
    correct = total = 0
    splits = 10
    for s in range(splits):
        lo, hi = s * n_pairs // splits, (s + 1) * n_pairs // splits
        if lo == hi:
            continue
        part = pairs[lo:hi]
        pred = model.predict_pairs(part)
        for j, (pa, pb) in enumerate(part):
            y = load_compare_labels(pa, pb, classes)
            for k in range(classes):
                ya, yb = y[2 * k], y[2 * k + 1]
                if ya == SECRET_NUM or ya == yb:
                    continue
                total += 1
                if (ya < yb) == (pred[j, 2 * k] < pred[j, 2 * k + 1]):
                    correct += 1
        acc = correct / max(total, 1)
        print(f"{s + 1}: Acc: {acc:f}, {len(part)} images")
    return correct / max(total, 1)


def sort_master(cfg: str, weights, argv, *, device="cuda"):
    """SortMaster3000 (compare.c:228-262): sort the list with the net
    as comparator — cmp(a,b) = +1 when slot[2c] beats slot[2c+1] for
    the hardcoded class 7 (reference `boxes[i].class = 7`)."""
    list_path = find_value(argv, "-list", "data/compare.sort.list")
    cls = find_value(argv, "-class", 7, int)
    model = CompareModel(cfg, weights, device=device)
    paths = _read_list(list_path)
    n_cmp = [0]

    def cmp(a, b):
        n_cmp[0] += 1
        p = model.predict_pairs([(a, b)])[0]
        return 1 if p[2 * cls] > p[2 * cls + 1] else -1

    out = sorted(paths, key=functools.cmp_to_key(cmp))
    for p in out:
        print(p)
    print(f"Sorted in {n_cmp[0]} compares")
    return out


def _elo_update(elos, ia, ib, cls, result, k=32.0):
    """bbox_update (compare.c:193-202): standard elo, K=32."""
    ea = 1.0 / (1.0 + 10.0 ** ((elos[ib, cls] - elos[ia, cls]) / 400.0))
    eb = 1.0 / (1.0 + 10.0 ** ((elos[ia, cls] - elos[ib, cls]) / 400.0))
    sa, sb = (1.0, 0.0) if result else (0.0, 1.0)
    elos[ia, cls] += k * (sa - ea)
    elos[ib, cls] += k * (sb - eb)


def battle_royale(cfg: str, weights, argv, *, rng=None,
                  all_rounds: int = 4, class_rounds: int = 100,
                  out_dir: str = "results", device="cuda"):
    """BattleRoyaleWithCheese (compare.c:264-341): elo tournament.
    4 all-class rounds over shuffled pairs, then per class: sort by
    elo, keep the top half, 100 rounds of sorta-shuffled (10 sections)
    neighbor fights with field shrink 9/10 for the first 20, log the
    survivors to results/battle_<class>.log. Every round's fights run
    as one batched forward (the reference fights serially at batch 1).
    Returns the (images, classes) elos.
    """
    list_path = find_value(argv, "-list", "data/compare.sort.list")
    classes = find_value(argv, "-classes", 20, int)
    rng = rng or np.random.default_rng(0)
    model = CompareModel(cfg, weights, device=device)
    paths = _read_list(list_path)
    total_n = len(paths)
    elos = np.full((total_n, classes), 1500.0, np.float64)
    order = np.arange(total_n)
    n_fights = [0]

    def fight_round(idx, cls):
        """One round: consecutive index pairs fight; batched forward,
        elo updates applied in pair order (order within a round does
        not interact — each box fights once)."""
        pairs = [(paths[idx[2 * i]], paths[idx[2 * i + 1]])
                 for i in range(len(idx) // 2)]
        if not pairs:
            return
        pred = model.predict_pairs(pairs)
        n_fights[0] += len(pairs)
        for i in range(len(pairs)):
            ia, ib = idx[2 * i], idx[2 * i + 1]
            for c in range(classes):
                if cls < 0 or cls == c:
                    result = pred[i, 2 * c] > pred[i, 2 * c + 1]
                    _elo_update(elos, ia, ib, c, result)

    for r in range(1, all_rounds + 1):
        print(f"Round: {r}")
        rng.shuffle(order)
        fight_round(order, -1)

    os.makedirs(out_dir, exist_ok=True)
    # The reference keeps ONE physical boxes array across classes and
    # re-sorts only the first N entries each round — an eliminated box
    # never re-enters the pool even if its elo later exceeds a pool
    # member's (compare.c:313-330). `order` persists the same way.
    for cls in range(classes):
        n = total_n
        order = order[np.argsort(-elos[order, cls], kind="stable")]
        n //= 2
        for r in range(1, class_rounds + 1):
            # sorta_shuffle(…, 10) (utils.c:32): shuffle within 10
            # contiguous elo-sorted sections — near-neighbors fight
            for s in range(10):
                lo, hi = n * s // 10, n * (s + 1) // 10
                seg = order[lo:hi]
                rng.shuffle(seg)
                order[lo:hi] = seg
            fight_round(order[:n], cls)
            head = order[:n]
            order[:n] = head[np.argsort(-elos[head, cls], kind="stable")]
            if r <= 20:
                n = (n * 9 // 10) // 2 * 2
        with open(os.path.join(out_dir, f"battle_{cls}.log"), "w") as f:
            for i in order[:n]:
                f.write(f"{paths[i]} {elos[i, cls]:f}\n")
    print(f"Tournament in {n_fights[0]} compares")
    return elos


__all__ = ["validate_compare", "sort_master", "battle_royale",
           "CompareModel"]
