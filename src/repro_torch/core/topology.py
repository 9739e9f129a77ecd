"""Communication topologies for federated aggregation.

Host-level (index lists) and mesh-level (axis_index_groups for
`jax.lax` collectives) descriptions of the same graphs.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def hierarchical_groups(num_clients: int, num_groups: int) -> List[List[int]]:
    """Contiguous group assignment: clients -> group servers (HFL tier 1)."""
    assert num_clients % num_groups == 0
    per = num_clients // num_groups
    return [list(range(g * per, (g + 1) * per)) for g in range(num_groups)]


def ring_neighbors(num_clients: int, degree: int = 2) -> List[List[int]]:
    """Gossip ring: each client's neighbor set (excluding itself)."""
    half = degree // 2
    out = []
    for c in range(num_clients):
        nbrs = []
        for d in range(1, half + 1):
            nbrs += [(c - d) % num_clients, (c + d) % num_clients]
        out.append(sorted(set(nbrs) - {c}))
    return out


def full_graph(num_clients: int) -> List[List[int]]:
    return [[j for j in range(num_clients) if j != c]
            for c in range(num_clients)]


def sample_participants(rng: np.random.Generator, num_clients: int,
                        fraction: float) -> np.ndarray:
    """At least one participant; uniform without replacement (AFL rounds)."""
    k = max(1, int(round(fraction * num_clients)))
    return np.sort(rng.choice(num_clients, size=k, replace=False))


def mesh_axis_groups(axis_size: int, num_groups: int) -> List[List[int]]:
    """axis_index_groups for a two-tier psum over a mesh axis (HFL tier 1)."""
    assert axis_size % num_groups == 0
    per = axis_size // num_groups
    return [list(range(g * per, (g + 1) * per)) for g in range(num_groups)]
