"""The key-value dataset table Omega (paper §III-B / §IV-B).

A copy of ``repro.core.table`` (numpy only): the port imports
nothing of the reference package.

Keys are token-to-expert mappings z = (layer e, f1, f2, f3, expert i);
values are occurrence counts. The table is profiled from >=100 samples of
the dataset, and the BO loop (Alg. 2) adjusts Q entries per iteration.

Keys are bit-packed into int64 so profiling and posterior computation stay
vectorized; a plain dict remains the mutable source of truth.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

import numpy as np

from repro_torch.core.features import LayerRecords

# bit layout: layer(6) | f1(18) | f2(14) | f3(18) | expert(7) = 63 (sign-safe)
_B_E, _B_F3, _B_F2, _B_F1 = 7, 18, 14, 18
MAX_LAYERS = 1 << 6


def pack_key(layer, f1, f2, f3, expert) -> np.ndarray:
    layer = np.asarray(layer, np.int64)
    f1 = np.asarray(f1, np.int64)
    f2 = np.asarray(f2, np.int64)
    f3 = np.asarray(f3, np.int64)
    expert = np.asarray(expert, np.int64)
    key = layer
    key = (key << _B_F1) | f1
    key = (key << _B_F2) | (f2 & ((1 << _B_F2) - 1))
    key = (key << _B_F3) | f3
    key = (key << _B_E) | expert
    return key


def unpack_key(key: np.ndarray):
    key = np.asarray(key, np.int64)
    expert = key & ((1 << _B_E) - 1)
    key >>= _B_E
    f3 = key & ((1 << _B_F3) - 1)
    key >>= _B_F3
    f2 = key & ((1 << _B_F2) - 1)
    key >>= _B_F2
    f1 = key & ((1 << _B_F1) - 1)
    layer = key >> _B_F1
    return layer, f1, f2, f3, expert


@dataclass
class KVTable:
    """Mutable counts table + dataset token-frequency prior P'(.)"""

    num_layers: int
    num_experts: int
    vocab_size: int
    counts: Dict[int, float] = field(default_factory=dict)
    token_freq: np.ndarray = field(default=None)  # type: ignore

    def __post_init__(self):
        if self.token_freq is None:
            self.token_freq = np.zeros(self.vocab_size)

    # -------------------------------------------------------------- profiling
    def observe_tokens(self, tokens: np.ndarray) -> None:
        """Update the raw dataset frequency P'(f) (used for P'(f3))."""
        binc = np.bincount(np.asarray(tokens).ravel(),
                           minlength=self.vocab_size)
        self.token_freq = self.token_freq + binc

    def add_records(self, recs: Iterable[LayerRecords]) -> None:
        for r in recs:
            k = r.experts.shape[1]
            for j in range(k):
                keys = pack_key(r.layer, r.token_id, r.position,
                                r.attention_id, r.experts[:, j])
                uniq, cnt = np.unique(keys, return_counts=True)
                for key, c in zip(uniq.tolist(), cnt.tolist()):
                    self.counts[key] = self.counts.get(key, 0.0) + float(c)

    # ------------------------------------------------------------- adjustment
    def set_entry(self, layer: int, f1: int, f2: int, f3: int,
                  expert: int, value: float) -> None:
        if not np.isfinite(value):
            raise ValueError(f"non-finite table value {value!r} for key "
                             f"({layer}, {f1}, {f2}, {f3}, {expert})")
        key = int(pack_key(layer, f1, f2, f3, expert))
        if value <= 0:
            self.counts.pop(key, None)
        else:
            self.counts[key] = float(value)

    def get_entry(self, layer: int, f1: int, f2: int, f3: int,
                  expert: int) -> float:
        return self.counts.get(int(pack_key(layer, f1, f2, f3, expert)), 0.0)

    def entries(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self.counts:
            return (np.zeros(0, np.int64), np.zeros(0))
        keys = np.fromiter(self.counts.keys(), np.int64, len(self.counts))
        vals = np.fromiter(self.counts.values(), float, len(self.counts))
        return keys, vals

    # -------------------------------------------------------- live telemetry
    def ingest_telemetry(self, telemetry) -> int:
        """Fold live serving observations into the table.

        ``telemetry`` is duck-typed (:class:`repro.serving.telemetry
        .ExpertTelemetry`): anything with ``flush_to_table(table)`` that
        updates ``token_freq`` and calls ``add_records``. Returns the
        number of records ingested; an engine that served zero tokens
        flushes nothing and returns 0 (a valid no-op, not an error)."""
        if telemetry is None:
            raise ValueError(
                "telemetry is None — the serving engine has no expert "
                "telemetry (dense model or collect_telemetry=False)")
        return int(telemetry.flush_to_table(self))

    def demand_matrix(self) -> np.ndarray:
        """(num_layers, num_experts) routed-token counts summed over keys.

        Non-finite counts (corrupted ingest, bad BO adjustments) are
        dropped rather than propagated into the deployment planner, and
        an empty table yields an all-zero matrix."""
        d = np.zeros((self.num_layers, self.num_experts))
        keys, vals = self.entries()
        if len(keys):
            finite = np.isfinite(vals)
            keys, vals = keys[finite], vals[finite]
            layer, _, _, _, expert = unpack_key(keys)
            np.add.at(d, (layer, expert), vals)
        return d

    def copy(self) -> "KVTable":
        t = KVTable(self.num_layers, self.num_experts, self.vocab_size,
                    counts=dict(self.counts),
                    token_freq=self.token_freq.copy())
        return t

    def __len__(self) -> int:
        return len(self.counts)

    @property
    def token_prob(self) -> np.ndarray:
        tot = self.token_freq.sum()
        if tot == 0:
            return np.full(self.vocab_size, 1.0 / self.vocab_size)
        return self.token_freq / tot
