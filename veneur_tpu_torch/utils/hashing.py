"""Hash functions used for metric routing and sketch insertion.

The 32-bit FNV-1a digest keys every metric for worker routing, matching the
reference's use of fnv1a over (name, type, joined-tags) at parse time
(reference: samplers/parser.go:325-420). The 64-bit variant feeds the
HyperLogLog register/rank split (reference vendored axiomhq/hyperloglog uses
a 64-bit hash the same way).

Both scalar (Python int) and vectorized (numpy array-of-bytes) forms are
provided; the C++ native parser (native/) supersedes the scalar path on hot
ingest loops when available.
"""

from __future__ import annotations

import numpy as np

FNV1A_32_OFFSET = 2166136261
FNV1A_32_PRIME = 16777619
FNV1A_64_OFFSET = 0xCBF29CE484222325
FNV1A_64_PRIME = 0x100000001B3

_U32 = 0xFFFFFFFF
_U64 = 0xFFFFFFFFFFFFFFFF


def fnv1a_32(data: bytes, h: int = FNV1A_32_OFFSET) -> int:
    """32-bit FNV-1a over ``data``, continuing from state ``h``."""
    for b in data:
        h = ((h ^ b) * FNV1A_32_PRIME) & _U32
    return h


def fnv1a_32_str(s: str, h: int = FNV1A_32_OFFSET) -> int:
    return fnv1a_32(s.encode("utf-8"), h)


def fnv1a_64(data: bytes, h: int = FNV1A_64_OFFSET) -> int:
    """64-bit FNV-1a over ``data``, continuing from state ``h``."""
    for b in data:
        h = ((h ^ b) * FNV1A_64_PRIME) & _U64
    return h


def metric_digest(name: str, mtype: str, joined_tags: str) -> int:
    """The 32-bit routing digest of a metric: fnv1a(name + type + joined_tags).

    Mirrors the digest accumulation order of the reference parser
    (samplers/parser.go:325-420: name, then type, then joined tags).
    """
    h = fnv1a_32_str(name)
    h = fnv1a_32_str(mtype, h)
    h = fnv1a_32_str(joined_tags, h)
    return h


def fmix64(h: int) -> int:
    """murmur3's 64-bit finalizer: full avalanche over all bits."""
    h &= _U64
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _U64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _U64
    h ^= h >> 33
    return h


def hll_hash(value: bytes) -> int:
    """64-bit hash for HyperLogLog insertion.

    FNV-1a 64 followed by a murmur3 finalizer: raw FNV's top bits barely
    avalanche on short sequential keys (statsd set members are exactly
    that), and HLL takes its register index from the top bits. The precise
    function only needs to be (a) well mixed and (b) identical across every
    host in a deployment, since HLL registers merge across hosts. This
    intentionally differs from the reference's vendored hash — our wire
    format is our own (see distributed/codec.py).
    """
    return fmix64(fnv1a_64(value))


def hll_hash_batch(values: list[bytes]) -> np.ndarray:
    """Batch HLL hashing; returns uint64 array."""
    out = np.empty(len(values), dtype=np.uint64)
    for i, v in enumerate(values):
        out[i] = fmix64(fnv1a_64(v))
    return out


# ---------------------------------------------------------------------------
# MetroHash64 — the Go fleet's set-element hash.
#
# The reference's HLL inserts hash set members with metro64 seed=1337
# (vendored axiomhq/hyperloglog utils.go:68-70 → dgryski/go-metro). HLL
# unions are only valid when every inserter uses the same element hash, so
# interop deployments (set series shared between Go and tpu instances)
# must hash with this instead of hll_hash — config knob set_hash: metro.

_M_K0 = 0xD6D018F5
_M_K1 = 0xA2AA033B
_M_K2 = 0x62992FC1
_M_K3 = 0x30BC5B29


def _rotr(v: int, k: int) -> int:
    return ((v >> k) | (v << (64 - k))) & _U64


def metro_hash64(data: bytes, seed: int = 1337) -> int:
    """64-bit MetroHash of ``data`` (matches dgryski/go-metro Hash64)."""
    h = ((seed + _M_K2) * _M_K0) & _U64
    n = len(data)
    off = 0
    if n >= 32:
        v = [h, h, h, h]
        while n - off >= 32:
            v[0] = (v[0] + int.from_bytes(data[off:off + 8], "little")
                    * _M_K0) & _U64
            v[0] = (_rotr(v[0], 29) + v[2]) & _U64
            v[1] = (v[1] + int.from_bytes(data[off + 8:off + 16], "little")
                    * _M_K1) & _U64
            v[1] = (_rotr(v[1], 29) + v[3]) & _U64
            v[2] = (v[2] + int.from_bytes(data[off + 16:off + 24], "little")
                    * _M_K2) & _U64
            v[2] = (_rotr(v[2], 29) + v[0]) & _U64
            v[3] = (v[3] + int.from_bytes(data[off + 24:off + 32], "little")
                    * _M_K3) & _U64
            v[3] = (_rotr(v[3], 29) + v[1]) & _U64
            off += 32
        v[2] ^= (_rotr(((v[0] + v[3]) * _M_K0 + v[1]) & _U64, 37)
                 * _M_K1) & _U64
        v[3] ^= (_rotr(((v[1] + v[2]) * _M_K1 + v[0]) & _U64, 37)
                 * _M_K0) & _U64
        v[0] ^= (_rotr(((v[0] + v[2]) * _M_K0 + v[3]) & _U64, 37)
                 * _M_K1) & _U64
        v[1] ^= (_rotr(((v[1] + v[3]) * _M_K1 + v[2]) & _U64, 37)
                 * _M_K0) & _U64
        h = (h + (v[0] ^ v[1])) & _U64
    if n - off >= 16:
        v0 = (h + int.from_bytes(data[off:off + 8], "little") * _M_K2) & _U64
        v0 = (_rotr(v0, 29) * _M_K3) & _U64
        v1 = (h + int.from_bytes(data[off + 8:off + 16], "little")
              * _M_K2) & _U64
        v1 = (_rotr(v1, 29) * _M_K3) & _U64
        v0 ^= (_rotr((v0 * _M_K0) & _U64, 21) + v1) & _U64
        v1 ^= (_rotr((v1 * _M_K3) & _U64, 21) + v0) & _U64
        h = (h + v1) & _U64
        off += 16
    if n - off >= 8:
        h = (h + int.from_bytes(data[off:off + 8], "little") * _M_K3) & _U64
        h ^= (_rotr(h, 55) * _M_K1) & _U64
        off += 8
    if n - off >= 4:
        h = (h + int.from_bytes(data[off:off + 4], "little") * _M_K3) & _U64
        h ^= (_rotr(h, 26) * _M_K1) & _U64
        off += 4
    if n - off >= 2:
        h = (h + int.from_bytes(data[off:off + 2], "little") * _M_K3) & _U64
        h ^= (_rotr(h, 48) * _M_K1) & _U64
        off += 2
    if n - off >= 1:
        h = (h + data[off] * _M_K3) & _U64
        h ^= (_rotr(h, 37) * _M_K1) & _U64
    h ^= _rotr(h, 28)
    h = (h * _M_K0) & _U64
    h ^= _rotr(h, 29)
    return h


def metro_hash64_batch(values: list[bytes], seed: int = 1337) -> np.ndarray:
    out = np.empty(len(values), dtype=np.uint64)
    for i, v in enumerate(values):
        out[i] = metro_hash64(v, seed)
    return out
