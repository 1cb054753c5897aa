"""String-similarity metric + suggestion sorting (the port's copy of the
JAX package's ``utils.strmetric``).

Parity: the reference's first-party ``common`` crate provides a Levenshtein
``StrMetric`` and ``common::str::filter::sort_with`` used by the worker's
autocompletion (SURVEY.md §2.11, §2.15). This re-provides that capability:
a normalized (optionally case-insensitive) Levenshtein distance and a
stable sort of candidates by similarity to the query.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, TypeVar

T = TypeVar("T")


def levenshtein(a: str, b: str) -> int:
    """Classic edit distance, O(len(a)*len(b)) with a rolling row."""
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i]
        for j, cb in enumerate(b, start=1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


class Levenshtein:
    """Similarity in [0,1]; 1.0 = identical. ``ignore_case`` mirrors
    ``common::str::filter::Levenshtein::new(true)``."""

    def __init__(self, ignore_case: bool = True):
        self.ignore_case = ignore_case

    def similarity(self, target: str, query: str) -> float:
        if self.ignore_case:
            target, query = target.lower(), query.lower()
        # reward prefix/substring containment so short queries rank sanely
        if query and query in target:
            return 1.0 - (len(target) - len(query)) / (2.0 * max(len(target), 1))
        denom = max(len(target), len(query), 1)
        return 1.0 - levenshtein(target, query) / denom


def sort_with(
    metric: Levenshtein,
    items: Iterable[T],
    query: str,
    key: Callable[[T], str] = lambda it: it,  # type: ignore[assignment,return-value]
) -> list[T]:
    """Sort ``items`` by descending similarity of ``key(item)`` to ``query``.

    Stable: equal-similarity items keep their input order (like the
    reference's suggestion lists).
    """
    items_list: Sequence[T] = list(items)
    return sorted(
        items_list,
        key=lambda it: -metric.similarity(str(key(it)), query),
    )
