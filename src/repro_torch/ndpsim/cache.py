"""Set-associative LRU cache model for the Local Neighbor Cache (Fig. 13).

LNC-T: 8KB fully-associative, 64B lines, one line = 16 NLT entries (4B each)
       -> tagged by (node_id // 16), TLB-like.
LNC-D: 256KB 8-way, 64B lines, caches neighbor-list contents; an entry may
       span several lines (variable-length lists).
"""
from __future__ import annotations


class SetAssocCache:
    def __init__(self, capacity_bytes: int, line_bytes: int = 64, ways: int | None = None):
        self.line = line_bytes
        n_lines = max(1, capacity_bytes // line_bytes)
        self.ways = ways or n_lines          # None -> fully associative
        self.n_sets = max(1, n_lines // self.ways)
        self.sets = [dict() for _ in range(self.n_sets)]  # tag -> lru tick
        self.tick = 0
        self.hits = 0
        self.misses = 0

    def _probe(self, line_addr: int, insert: bool) -> bool:
        s = self.sets[line_addr % self.n_sets]
        self.tick += 1
        if line_addr in s:
            s[line_addr] = self.tick
            self.hits += 1
            return True
        self.misses += 1
        if insert:
            if len(s) >= self.ways:
                victim = min(s, key=s.get)
                del s[victim]
            s[line_addr] = self.tick
        return False

    def access(self, addr: int, size: int = 1, insert: bool = True) -> int:
        """Access [addr, addr+size); returns number of missing lines."""
        first = addr // self.line
        last = (addr + max(size, 1) - 1) // self.line
        missing = 0
        for la in range(first, last + 1):
            if not self._probe(la, insert):
                missing += 1
        return missing

    def contains(self, addr: int, size: int = 1) -> bool:
        first = addr // self.line
        last = (addr + max(size, 1) - 1) // self.line
        return all(la in self.sets[la % self.n_sets] for la in range(first, last + 1))

    def fill(self, addr: int, size: int = 1) -> int:
        """Insert without counting hit/miss stats (prefetch fills)."""
        first = addr // self.line
        last = (addr + max(size, 1) - 1) // self.line
        n_new = 0
        for la in range(first, last + 1):
            s = self.sets[la % self.n_sets]
            self.tick += 1
            if la not in s:
                n_new += 1
                if len(s) >= self.ways:
                    victim = min(s, key=s.get)
                    del s[victim]
            s[la] = self.tick
        return n_new

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0
