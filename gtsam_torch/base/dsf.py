"""Disjoint-set forest (union-find).

Counterpart of gtsam_tpu/base/dsf.py, a copy of it (reference
gtsam/base/DSFMap.h, DSFVector.{h,cpp}): host-side graph preprocessing, used
by the subgraph preconditioner's spanning tree (linear/pcg.py).
"""


class DSF:
    def __init__(self, n: int = 0):
        self.parent = list(range(n))
        self.rank = [0] * n

    def make_set(self) -> int:
        self.parent.append(len(self.parent))
        self.rank.append(0)
        return len(self.parent) - 1

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> int:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        return ra

    def sets(self):
        out = {}
        for i in range(len(self.parent)):
            out.setdefault(self.find(i), []).append(i)
        return out


class DSFMap:
    """Union-find over arbitrary hashable keys (DSFMap<IndexPair> analog)."""

    def __init__(self):
        self._ids = {}
        self._dsf = DSF()
        self._keys = []

    def _id(self, key):
        if key not in self._ids:
            self._ids[key] = self._dsf.make_set()
            self._keys.append(key)
        return self._ids[key]

    def merge(self, a, b):
        self._dsf.union(self._id(a), self._id(b))

    def find(self, key):
        return self._keys[self._dsf.find(self._id(key))]

    def sets(self):
        return {self._keys[root]: [self._keys[i] for i in members]
                for root, members in self._dsf.sets().items()}
