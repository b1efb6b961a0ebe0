"""Hierarchical data-cache model (paper §4.3).

Each affiliation owns an 8 MB L1 shared by its three clusters; a global L2
holds the rest of the 320 MB SRAM budget.  The dominant cached objects are
key-switching keys and precomputed plaintext diagonals — exactly what Fig. 8
sweeps.  We model an LRU over named buffers: an access either hits (no HBM
traffic) or misses (buffer streamed from HBM and inserted, evicting LRU).

Ciphertext working polynomials are pinned in L1 (the paper sizes L1 so each
affiliation holds its active slice: 8 MB ≥ 2 polys × 2^16/8 × limbs × 4B).
"""

from __future__ import annotations

import collections

MB = 1 << 20


class LruCache:
    def __init__(self, capacity_bytes: float):
        self.capacity = float(capacity_bytes)
        self.used = 0.0
        self._entries: "collections.OrderedDict[str, float]" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.hbm_bytes = 0.0

    def access(self, key: str, nbytes: float) -> float:
        """Returns HBM bytes transferred (0 on hit)."""
        if key in self._entries:
            self._entries.move_to_end(key)
            self.hits += 1
            return 0.0
        self.misses += 1
        self.hbm_bytes += nbytes
        if nbytes <= self.capacity:
            while self.used + nbytes > self.capacity and self._entries:
                _, sz = self._entries.popitem(last=False)
                self.used -= sz
            self._entries[key] = nbytes
            self.used += nbytes
        return nbytes

    def spill(self, nbytes: float) -> float:
        """Preemption: working set written to HBM and read back later."""
        self.hbm_bytes += 2 * nbytes
        return 2 * nbytes

    @property
    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class HierarchicalCache:
    """L1-per-affiliation backed by a shared global L2.

    An access first probes the affiliation L1, then L2; a miss in both streams
    from HBM and fills both levels (inclusive).
    """

    def __init__(self, n_affiliations: int, l1_bytes: float, l2_bytes: float):
        self.l1 = [LruCache(l1_bytes) for _ in range(n_affiliations)]
        self.l2 = LruCache(l2_bytes)

    def access(self, affiliation: int, key: str, nbytes: float) -> float:
        if self.l1[affiliation].access(key, nbytes) == 0.0:
            return 0.0
        # L1 miss: charge the L1 fill to on-chip traffic; probe L2
        missed = self.l2.access(key, nbytes)
        return missed

    @property
    def hbm_bytes(self) -> float:
        return self.l2.hbm_bytes

    def hit_ratio(self) -> float:
        h = sum(c.hits for c in self.l1) + self.l2.hits
        m = self.l2.misses
        total_l1 = sum(c.hits + c.misses for c in self.l1)
        return (total_l1 - m) / total_l1 if total_l1 else 0.0
