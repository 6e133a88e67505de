# Copied from quickstep_tpu/storage/eviction.py; only the package name in imports differs.
"""HBM buffer-pool eviction policies.

Successors of the reference's EvictionPolicy hierarchy
(storage/EvictionPolicy.hpp:43 `chooseBlockToEvict`; impls EvictAnyBlock :136,
UniformRandom :164, LRU-K via LRUKEvictionPolicyFactory :197). The "blocks"
here are whole resident device tables keyed by (name, version) — the unit the
executor faults into HBM.

LRU-K (the reference's factory default family): the victim is the entry whose
K-th most recent reference is oldest ("backward K-distance"); entries with
fewer than K references have infinite distance and are evicted first — this is
what makes LRU-K scan-resistant: one sequential touch cannot displace the hot
working set.
"""

from __future__ import annotations

import collections
import random
from typing import Dict, Hashable, Iterable, Optional


class EvictionPolicy:
    """Reference-count-free policy interface: the executor reports references
    and asks for a victim among current residents."""

    def block_referenced(self, key: Hashable) -> None:
        pass

    def block_evicted(self, key: Hashable) -> None:
        pass

    def choose_victim(self, candidates: Iterable[Hashable]) -> Hashable:
        raise NotImplementedError


class EvictAnyPolicy(EvictionPolicy):
    """EvictAnyBlock analog: any resident entry will do."""

    def choose_victim(self, candidates):
        return next(iter(candidates))


class UniformRandomPolicy(EvictionPolicy):
    """UniformRandom analog (seeded for reproducibility)."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)

    def choose_victim(self, candidates):
        cands = list(candidates)
        return cands[self._rng.randrange(len(cands))]


class LRUKPolicy(EvictionPolicy):
    """LRU-K: evict the entry with the oldest K-th most recent reference.
    K=1 degenerates to classic LRU."""

    def __init__(self, k: int = 2):
        assert k >= 1
        self.k = k
        self._history: Dict[Hashable, collections.deque] = {}
        self._tick = 0

    def block_referenced(self, key):
        self._tick += 1
        h = self._history.get(key)
        if h is None:
            h = self._history[key] = collections.deque(maxlen=self.k)
        h.append(self._tick)

    def block_evicted(self, key):
        self._history.pop(key, None)

    def _backward_k_distance(self, key) -> float:
        h = self._history.get(key)
        if h is None or len(h) < self.k:
            return float("-inf")     # <K references: infinite distance
        return h[0]                  # time of K-th most recent reference

    def choose_victim(self, candidates):
        return min(candidates, key=self._backward_k_distance)


def make_policy(spec: str, k: int = 2, seed: int = 0) -> EvictionPolicy:
    """Factory (EvictionPolicy::Factory analog). spec: eviction_policy flag
    value — 'lru-k' | 'lru' | 'uniform-random' | 'evict-any'."""
    spec = spec.lower().replace("_", "-")
    if spec in ("lru-k", "lruk"):
        return LRUKPolicy(k)
    if spec == "lru":
        return LRUKPolicy(1)
    if spec in ("uniform-random", "random"):
        return UniformRandomPolicy(seed)
    if spec in ("evict-any", "any"):
        return EvictAnyPolicy()
    raise ValueError(f"unknown eviction policy: {spec}")
