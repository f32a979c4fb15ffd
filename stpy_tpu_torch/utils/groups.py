"""Group structures for additive kernels, host-side: the port's own copy of
stpy_tpu/utils/groups.py (pure Python)."""

from __future__ import annotations


def generate_groups(d: int) -> list[list[list[int]]]:
    """All set partitions of {0..d-1} (Bell(d) of them), in the JAX
    package's order: the candidate group structures of the discrete
    hyperparameter search. Keep d small (≤ 6)."""
    if d == 0:
        return [[]]
    partitions = [[[0]]]
    for el in range(1, d):
        new = []
        for part in partitions:
            for i in range(len(part)):
                new.append(
                    [g + [el] if i == j else list(g) for j, g in enumerate(part)]
                )
            new.append([list(g) for g in part] + [[el]])
        partitions = new
    return partitions


def all_pairs(d: int) -> list[list[int]]:
    return [[i, j] for i in range(d) for j in range(i + 1, d)]


def singletons(d: int) -> list[list[int]]:
    return [[i] for i in range(d)]
