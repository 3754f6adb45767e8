"""DNA nt6 codec: {0:$, 1:A, 2:C, 3:G, 4:T, 5:N}; complement(c) = 5-c for ACGT.

Mirrors the alphabet of reference seq.c:12-56 (table semantics, fresh code).
"""

import numpy as np

# ASCII -> nt6; everything unknown maps to 5 (N); acgt/ACGT -> 1..4
NT6_TABLE = np.full(256, 5, dtype=np.uint8)
for _i, _b in enumerate("ACGT"):
    NT6_TABLE[ord(_b)] = _i + 1
    NT6_TABLE[ord(_b.lower())] = _i + 1

NT6_TO_ASCII = np.frombuffer(b"$ACGTN", dtype=np.uint8)


def encode(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> nt6 uint8 array."""
    if isinstance(seq, str):
        seq = seq.encode()
    return NT6_TABLE[np.frombuffer(seq, dtype=np.uint8)]


def decode(nt6: np.ndarray) -> str:
    """nt6 array -> ASCII string ($ACGTN)."""
    return NT6_TO_ASCII[np.asarray(nt6, dtype=np.uint8)].tobytes().decode()
