"""Client data partitioning for federated training.

* `iid_partition` — shuffle, equal split (the paper's Figure 8 setting).
* `dirichlet_partition` — non-IID label skew via Dirichlet(alpha) per
  client (paper §4 future-work direction 1; implemented as a beyond-paper
  feature and exercised in the ablation benchmarks).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def iid_partition(labels: np.ndarray, num_clients: int, seed=0
                  ) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(part) for part in np.array_split(idx, num_clients)]


def dirichlet_partition(labels: np.ndarray, num_clients: int, alpha=0.5,
                        seed=0, min_per_client=8,
                        max_attempts=100) -> List[np.ndarray]:
    """Resamples (reseeding deterministically) until every client holds at
    least `min_per_client` samples, for at most `max_attempts` draws: a
    small `alpha` with many clients can make the floor vanishingly
    unlikely, and the old unbounded loop would spin forever."""
    if min_per_client * num_clients > len(labels):
        raise ValueError(
            f"min_per_client={min_per_client} x {num_clients} clients "
            f"needs {min_per_client * num_clients} samples, but only "
            f"{len(labels)} are available")
    n_classes = int(labels.max()) + 1
    for attempt in range(max_attempts):
        rng = np.random.default_rng(seed + attempt)
        parts = [[] for _ in range(num_clients)]
        for c in range(n_classes):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet([alpha] * num_clients)
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for cid, chunk in enumerate(np.split(idx_c, cuts)):
                parts[cid].extend(chunk)
        if min(len(p) for p in parts) >= min_per_client:
            return [np.sort(np.array(p)) for p in parts]
    raise RuntimeError(
        f"dirichlet_partition: no draw satisfied min_per_client="
        f"{min_per_client} in {max_attempts} attempts (alpha={alpha}, "
        f"num_clients={num_clients}, n={len(labels)}) — the skew makes "
        f"the floor infeasible; raise alpha, lower min_per_client, or "
        f"reduce num_clients")


def partition_stats(labels: np.ndarray, parts: List[np.ndarray]):
    n_classes = int(labels.max()) + 1
    table = np.zeros((len(parts), n_classes), int)
    for i, p in enumerate(parts):
        for c in range(n_classes):
            table[i, c] = int(np.sum(labels[p] == c))
    return table
