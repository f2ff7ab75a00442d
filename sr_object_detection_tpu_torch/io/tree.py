"""YOLO9000 WordTree reader (src_yolo2/tree.c:53-103).

Tree file format: one ``name parent_index`` pair per line. Sibling runs
(consecutive nodes sharing a parent) form "groups"; the region/softmax
layers softmax within each group. We additionally precompute the arrays
the vectorized TPU ops need: per-class group ids for segmented softmax
and parent indices for hierarchy path products.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WordTree:
    n: int
    parent: np.ndarray        # (n,) int32, -1 for roots
    group: np.ndarray         # (n,) int32 group id per node
    group_size: np.ndarray    # (groups,) int32
    group_offset: np.ndarray  # (groups,) int32
    leaf: np.ndarray          # (n,) bool
    names: tuple[str, ...]

    @property
    def groups(self) -> int:
        return len(self.group_size)


def read_tree(path: str, pad_to: int | None = None) -> WordTree:
    parents: list[int] = []
    names: list[str] = []
    group_sizes: list[int] = []
    group_offsets: list[int] = []
    group_ids: list[int] = []
    last_parent = -1
    group_size = 0
    groups = 0
    n = 0
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for raw in f:
            # the shipped 9k.tree contains embedded NULs (corrupt export);
            # the C reference tolerates them because sscanf stops at the
            # first NUL — mirror that robustness
            line = raw.replace("\x00", " ").strip()
            if not line:
                continue
            parts = line.split()
            name = parts[0]
            try:
                parent = int(parts[1]) if len(parts) > 1 else -1
            except ValueError:
                parent = -1
            parents.append(parent)
            names.append(name)
            if parent != last_parent:
                groups += 1
                group_offsets.append(n - group_size)
                group_sizes.append(group_size)
                group_size = 0
                last_parent = parent
            group_ids.append(groups)
            n += 1
            group_size += 1
    # graceful handling of the truncated 9k.tree shipped with the
    # reference (8714 records for 9418 declared classes — the C code
    # reads out of bounds here): pad missing tail nodes as independent
    # roots, each its own sibling group.
    if pad_to is not None and n < pad_to:
        for extra in range(n, pad_to):
            groups += 1
            group_offsets.append(n - group_size)
            group_sizes.append(group_size)
            group_size = 0
            last_parent = -2 - extra   # force a fresh group every node
            parents.append(-1)
            names.append(f"<pad{extra}>")
            group_ids.append(groups)
            n += 1
            group_size += 1
    groups += 1
    group_offsets.append(n - group_size)
    group_sizes.append(group_size)

    # Matches tree.c exactly: last_parent starts at -1, so a file whose
    # first lines are roots (parent -1, the real-world case) opens group 0
    # implicitly; the flush on each parent change records the *previous*
    # group's offset/size, and the final flush records the last group.
    group_ids_arr = np.asarray(group_ids, np.int32)
    group_sizes_arr = np.asarray(group_sizes, np.int32)
    group_offsets_arr = np.asarray(group_offsets, np.int32)

    parent_arr = np.asarray(parents, np.int32)
    # dangling parents (truncated file referencing missing nodes) are
    # treated as roots so downstream gathers stay in bounds
    parent_arr = np.where(parent_arr >= n, -1, parent_arr)
    leaf = np.ones(n, bool)
    valid = parent_arr >= 0
    leaf[parent_arr[valid]] = False

    return WordTree(
        n=n,
        parent=parent_arr,
        group=group_ids_arr,
        group_size=group_sizes_arr,
        group_offset=group_offsets_arr,
        leaf=leaf,
        names=tuple(names),
    )


__all__ = ["WordTree", "read_tree"]
