"""Population: the full N-client federation, of which only K train per round
— the port of `repro/fed/population.py`, whose only JAX use (`jax.tree` over
the personalized tails) becomes the port's `tree.py` in `jax.tree` order.

The seed repo stacked ALL clients into one (K, n, ...) tensor — fine for the
paper's K=5 reproduction, a dead end at population scale. A `Population`
instead holds the base dataset ONCE plus per-client index arrays (from
`data/federated.py`'s `iid_indices` / `dirichlet_indices`), and materializes
only the sampled cohort via `gather()`. Memory is O(dataset + N) instead of
O(N * dataset); the cohort tensor stays exactly the (K, n_local, ...) layout
`SFPromptTrainer._round` vmaps over.

Per-client PERSISTENT state rides along:
  * `sizes`        — true pre-padding sample counts (FedAvg / weighted
                     sampling weights),
  * `times_sampled`, `last_round` — participation bookkeeping,
  * optional personalized tails (`set_tails`/`get_tails`): the post-round,
    pre-aggregation tail of each sampled client, in the style of the hetero
    plans' personalized tails (flexible personalized split FL,
    arXiv:2508.10349) — clients keep a private tail while the prompt and
    the aggregated global tail stay shared.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.data.federated import dirichlet_indices, iid_indices
from repro_torch.tree import tree_flatten, tree_map, tree_map_with_path


class Population:
    def __init__(self, data: Dict[str, np.ndarray],
                 client_indices: Sequence[np.ndarray],
                 sizes: Optional[np.ndarray] = None):
        lens = {len(idx) for idx in client_indices}
        if len(lens) != 1:
            raise ValueError(f"client index arrays must share one length "
                             f"for stacking; got {sorted(lens)}")
        self.data = data
        self.client_indices = [np.asarray(i, dtype=np.int64)
                               for i in client_indices]
        self.n_clients = len(client_indices)
        self.n_local = lens.pop()
        self.sizes = (np.asarray(sizes, dtype=np.int64) if sizes is not None
                      else np.full((self.n_clients,), self.n_local,
                                   dtype=np.int64))
        self.times_sampled = np.zeros((self.n_clients,), dtype=np.int64)
        self.last_round = np.full((self.n_clients,), -1, dtype=np.int64)
        self._tails: Dict[int, Dict] = {}   # cid -> personalized tail pytree

    # ------------------------------------------------------- construction
    @classmethod
    def from_partition(cls, data: Dict[str, np.ndarray], n_clients: int, *,
                       scheme: str = "iid", alpha: float = 0.1,
                       seed: int = 0, label_key: str = "labels",
                       ) -> "Population":
        n = len(next(iter(data.values())))
        if n // n_clients < 1:
            raise ValueError(
                f"population of {n_clients} clients needs at least one "
                f"sample per client; dataset has only {n}")
        if scheme == "dirichlet":
            idx, sizes = dirichlet_indices(data[label_key], n_clients,
                                           alpha=alpha, seed=seed)
        elif scheme == "iid":
            idx, sizes = iid_indices(n, n_clients, seed=seed)
        else:
            raise ValueError(f"unknown scheme {scheme!r}")
        return cls(data, idx, sizes)

    @classmethod
    def from_client_list(cls, clients: Sequence[Dict[str, np.ndarray]],
                         ) -> "Population":
        """Adapt the legacy materialized form (list of per-client dicts)."""
        data = {k: np.concatenate([c[k] for c in clients])
                for k in clients[0]}
        sizes = [len(next(iter(c.values()))) for c in clients]
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        idx = [np.arange(offsets[i], offsets[i + 1], dtype=np.int64)
               for i in range(len(clients))]
        return cls(data, idx, np.asarray(sizes))

    # ------------------------------------------------------------- cohort
    def gather(self, cohort: Sequence[int]) -> Dict[str, np.ndarray]:
        """Materialize the sampled cohort: (K, n_local, ...) per key."""
        rows = np.stack([self.client_indices[int(c)] for c in cohort])
        return {k: v[rows] for k, v in self.data.items()}

    def cohort_sizes(self, cohort: Sequence[int]) -> np.ndarray:
        return self.sizes[np.asarray(cohort, dtype=np.int64)]

    def record_participation(self, cohort: Sequence[int],
                             round_idx: int) -> None:
        ids = np.asarray(cohort, dtype=np.int64)
        self.times_sampled[ids] += 1
        self.last_round[ids] = round_idx

    # ------------------------------------------------- personalized tails
    def set_tails(self, cohort: Sequence[int], stacked_tail) -> None:
        """Store each sampled client's post-training tail (leading K axis
        on every leaf of `stacked_tail`, host numpy arrays)."""
        for pos, cid in enumerate(cohort):
            self._tails[int(cid)] = tree_map(
                lambda x: np.asarray(x[pos]), stacked_tail)

    def get_tails(self, cohort: Sequence[int], default_tail,
                  *, always: bool = False) -> Optional[List]:
        """Per-client tails for a cohort (global tail for never-sampled
        clients); None if no client has a personalized tail yet.
        `always=True` returns the default-filled list even when nothing is
        personalized — the serving TenantBank wants one entry per tenant
        regardless."""
        if not self._tails and not always:
            return None
        return [self._tails.get(int(c), default_tail) for c in cohort]

    # ------------------------------------------------------------- resume
    def fingerprint(self) -> Dict[str, np.ndarray]:
        """Cheap identity of the partition a run was trained on: client
        count, shard size, and CRCs of the index arrays / true sizes.
        Checkpointed so a resume against a REBUILT population with
        different data flags fails loudly instead of silently replaying
        rounds on different client data."""
        idx_crc = 0
        for idx in self.client_indices:
            idx_crc = zlib.crc32(idx.tobytes(), idx_crc)
        shape_crc = 0
        for k in sorted(self.data):
            v = self.data[k]
            shape_crc = zlib.crc32(
                f"{k}:{v.shape}:{v.dtype}".encode(), shape_crc)
        return {"n_clients": np.int64(self.n_clients),
                "n_local": np.int64(self.n_local),
                "sizes_crc": np.int64(zlib.crc32(self.sizes.tobytes())),
                "indices_crc": np.int64(idx_crc),
                "data_shape_crc": np.int64(shape_crc)}

    def state_dict(self) -> Dict:
        """Nested dict of arrays — round-trips through checkpoint/io.py
        verbatim. Personalized tails are stored as leaf lists per client id
        (`restore_tails` rebuilds the pytree structure from a template)."""
        state: Dict = {
            "times_sampled": self.times_sampled.copy(),
            "last_round": self.last_round.copy(),
            "fingerprint": self.fingerprint(),
        }
        if self._tails:
            state["tails"] = {
                f"{cid:08d}": {str(i): np.asarray(leaf) for i, (_, leaf) in
                               enumerate(tree_flatten(tail))}
                for cid, tail in sorted(self._tails.items())}
        return state

    def load_state_dict(self, state: Dict) -> None:
        if "fingerprint" in state:
            got = {k: int(v) for k, v in state["fingerprint"].items()}
            want = {k: int(v) for k, v in self.fingerprint().items()}
            if got != want:
                diff = {k: (got[k], want[k]) for k in want
                        if got.get(k) != want[k]}
                raise ValueError(
                    f"population mismatch on resume: checkpoint vs rebuilt "
                    f"partition differ on {diff} — rebuild with the "
                    f"original data flags (samples/clients/scheme/seed)")
        self.times_sampled = np.asarray(state["times_sampled"],
                                        dtype=np.int64).copy()
        self.last_round = np.asarray(state["last_round"],
                                     dtype=np.int64).copy()
        # drop tails from any rounds past the checkpoint — a resumed run
        # must replay from exactly the checkpointed per-client state
        self._tails = {}
        # structure-free leaves; `restore_tails(template)` rebuilds pytrees
        self._tail_leaves = state.get("tails", {})

    def restore_tails(self, template) -> None:
        """Rebuild personalized tails from a loaded state, using `template`
        (any tail pytree, e.g. the global tail) for structure."""
        index = {p: str(i) for i, (p, _) in enumerate(tree_flatten(template))}
        for cid, leaves in getattr(self, "_tail_leaves", {}).items():
            self._tails[int(cid)] = tree_map_with_path(
                lambda p, _, leaves=leaves: leaves[index[p]], template)
