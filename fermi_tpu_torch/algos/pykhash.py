"""Bucket-faithful reimplementation of khash (reference khash.h).

The port's copy of fermi_tpu/algos/pykhash.py.

Downstream artifacts depend on khash *iteration order* (e.g. the UR:Z: lists
remap emits come from a bucket scan, and scaf's local assemblies consume them
in that order), so this replicates khash's layout exactly: 32-bit hash,
double-hash probing inc = ((k>>3 ^ k<<3)|1) & mask, 0.77 upper bound,
kick-out rehash on power-of-two resize, tombstone deletion.
"""

M32 = 0xFFFFFFFF

EMPTY, DELETED, USED = 2, 1, 0


def _hash64(key: int) -> int:
    key &= 0xFFFFFFFFFFFFFFFF
    return ((key >> 33) ^ key ^ (key << 11)) & M32


def _kroundup32(x: int) -> int:
    x -= 1
    x |= x >> 1
    x |= x >> 2
    x |= x >> 4
    x |= x >> 8
    x |= x >> 16
    return (x + 1) & M32


class KHash64:
    __slots__ = ("n_buckets", "size", "n_occupied", "upper_bound", "flags",
                 "keys", "vals")

    def __init__(self):
        self.n_buckets = 0
        self.size = 0
        self.n_occupied = 0
        self.upper_bound = 0
        self.flags = []
        self.keys = []
        self.vals = []

    def clear(self):
        if self.flags:
            for i in range(self.n_buckets):
                self.flags[i] = EMPTY
            self.size = self.n_occupied = 0

    def get(self, key):
        """Returns bucket index or n_buckets if absent."""
        if not self.n_buckets:
            return 0
        mask = self.n_buckets - 1
        k = _hash64(key)
        i = k & mask
        inc = (((k >> 3) ^ ((k << 3) & M32)) | 1) & mask
        last = i
        while self.flags[i] != EMPTY and (self.flags[i] == DELETED
                                          or self.keys[i] != key):
            i = (i + inc) & mask
            if i == last:
                return self.n_buckets
        return self.n_buckets if self.flags[i] != USED else i

    def resize(self, new_n_buckets):
        new_n_buckets = _kroundup32(new_n_buckets)
        if new_n_buckets < 4:
            new_n_buckets = 4
        if self.size >= int(new_n_buckets * 0.77 + 0.5):
            return
        new_flags = [EMPTY] * new_n_buckets
        if self.n_buckets < new_n_buckets:
            self.keys.extend([0] * (new_n_buckets - self.n_buckets))
            self.vals.extend([0] * (new_n_buckets - self.n_buckets))
        new_mask = new_n_buckets - 1
        for j in range(self.n_buckets):
            if self.flags[j] == USED:
                key = self.keys[j]
                val = self.vals[j]
                self.flags[j] = DELETED
                while True:  # kick-out
                    k = _hash64(key)
                    i = k & new_mask
                    inc = (((k >> 3) ^ ((k << 3) & M32)) | 1) & new_mask
                    while new_flags[i] != EMPTY:
                        i = (i + inc) & new_mask
                    new_flags[i] = USED
                    if i < self.n_buckets and self.flags[i] == USED:
                        self.keys[i], key = key, self.keys[i]
                        self.vals[i], val = val, self.vals[i]
                        self.flags[i] = DELETED
                    else:
                        self.keys[i] = key
                        self.vals[i] = val
                        break
        if self.n_buckets > new_n_buckets:
            del self.keys[new_n_buckets:]
            del self.vals[new_n_buckets:]
        self.flags = new_flags
        self.n_buckets = new_n_buckets
        self.n_occupied = self.size
        self.upper_bound = int(new_n_buckets * 0.77 + 0.5)

    def put(self, key):
        """Returns (bucket, ret): ret 0=present, 1=new-empty, 2=new-deleted."""
        if self.n_occupied >= self.upper_bound:
            if self.n_buckets > (self.size << 1):
                self.resize(self.n_buckets - 1)
            else:
                self.resize(self.n_buckets + 1)
        mask = self.n_buckets - 1
        x = site = self.n_buckets
        k = _hash64(key)
        i = k & mask
        if self.flags[i] == EMPTY:
            x = i
        else:
            inc = (((k >> 3) ^ ((k << 3) & M32)) | 1) & mask
            last = i
            while self.flags[i] != EMPTY and (self.flags[i] == DELETED
                                              or self.keys[i] != key):
                if self.flags[i] == DELETED:
                    site = i
                i = (i + inc) & mask
                if i == last:
                    x = site
                    break
            if x == self.n_buckets:
                if self.flags[i] == EMPTY and site != self.n_buckets:
                    x = site
                else:
                    x = i
        if self.flags[x] == EMPTY:
            self.keys[x] = key
            self.flags[x] = USED
            self.size += 1
            self.n_occupied += 1
            return x, 1
        if self.flags[x] == DELETED:
            self.keys[x] = key
            self.flags[x] = USED
            self.size += 1
            return x, 2
        return x, 0

    def delete(self, x):
        if x != self.n_buckets and self.flags[x] == USED:
            self.flags[x] = DELETED
            self.size -= 1

    def items_in_bucket_order(self):
        for i in range(self.n_buckets):
            if self.flags[i] == USED:
                yield self.keys[i], self.vals[i]

    def __contains__(self, key):
        return self.get(key) != self.n_buckets
