"""block-account positive: paged-KV accounting mutated outside the
manager lock."""


class Pool:
    def alloc(self):
        bid = self._free_blocks.pop()
        self._block_refs[bid] = 1
        return bid

    def repoint(self, sess, j, bid):
        sess.block_table[j] = bid
