"""The ingress's header hash, written from its definition: 31-bit FNV-1a
over the UTF-8 bytes of a header value, one feature column per field."""

from __future__ import annotations

import numpy as np

from xlbench.deploy import FIELDS


def fnv1a(s: str) -> int:
    h = 0x811C9DC5
    for byte in s.encode():
        h = ((h ^ byte) * 0x01000193) % (1 << 32)
    return h % (1 << 31)


def features(headers: dict) -> np.ndarray:
    """The feature columns of a request's headers (0 for a field the
    request does not carry)."""
    return np.array([fnv1a(headers[f]) if f in headers else 0
                     for f in FIELDS], np.int64)
