"""Prompt-prefix hashing for the paged prefix cache.

Ports `chain_hashes` (`shellac_tpu/inference/prefix.py:31`). The digests
are byte-equal to the reference's for the same tokens and block size:
a later KV fabric compares them across packages. The affinity helpers
(:54, :68) belong to the tier's router, which the port does not have.
"""

from __future__ import annotations

import hashlib
from typing import Any, List

import numpy as np


def chain_hashes(tokens: Any, block_size: int) -> List[bytes]:
    """Position-dependent content hashes of the full token blocks:
    h_j = H(h_{j-1} || block_j), so a block matches only when its whole
    prefix matches too, and so sits at the same absolute positions (its
    cached K is rotated for them). Tokens are canonicalized to
    contiguous int32 first, so a list and an array hash alike."""
    arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    out: List[bytes] = []
    h = b""
    for j in range(arr.size // block_size):
        h = hashlib.blake2b(
            h + arr[j * block_size:(j + 1) * block_size].tobytes(),
            digest_size=16,
        ).digest()
        out.append(h)
    return out
