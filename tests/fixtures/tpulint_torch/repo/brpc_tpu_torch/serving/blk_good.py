"""block-account negative: every mutation under the manager lock, or in
a *_locked helper whose callers hold it."""


class Pool:
    def __init__(self, n):
        self._free_blocks = list(range(n))
        self._block_refs = {}

    def alloc(self):
        with self._mu:
            return self._alloc_locked()

    def _alloc_locked(self):
        bid = self._free_blocks.pop()
        self._block_refs[bid] = 1
        return bid
