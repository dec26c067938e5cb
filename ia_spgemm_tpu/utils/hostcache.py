"""Bounded device->host view cache for the host planners.

Why: the host planners (slab packing, route probes, ELL widths) need
host numpy views of operand arrays that usually ORIGINATED on the host
(.mtx readers, CSR.from_scipy, bench builders). Re-pulling them with
np.asarray is a device-to-host copy of bytes the host just uploaded.

Entries are keyed by the DEVICE array's id; each entry pins a reference
to that array so a live key can never be recycled onto a different
array (the same invariant bitonic._BUILD_CACHE relies on). Values are
either a ready numpy array or a zero-arg thunk (evaluated once, then
memoized) — conversions register thunks that DERIVE the host view from
already-cached host data (e.g. the ELL grid from the source CSR's host
arrays) so registering costs nothing on the hot path.

The cache is a bounded FIFO: at most _MAX device arrays stay pinned.
"""

from __future__ import annotations

import numpy as np

_CACHE: dict = {}     # id -> [dev_ref, np_array | thunk]
_MAX = 24


def register(dev, host) -> None:
    """Associate a host view (numpy array or zero-arg thunk) with a
    device array. No-op for non-array `dev` (None etc.)."""
    if dev is None:
        return
    key = id(dev)
    if key not in _CACHE and len(_CACHE) >= _MAX:
        _CACHE.pop(next(iter(_CACHE)))
    _CACHE[key] = [dev, host]


def peek(x):
    """The cached host view WITHOUT any device transfer (evaluating a
    registered thunk is host-only work); None when unknown."""
    e = _CACHE.get(id(x))
    if e is None:
        return None
    val = e[1]
    if callable(val):
        val = np.asarray(val())
        e[1] = val
    return val


def host_view(x) -> np.ndarray:
    """Host numpy view of a device array: the cached copy when known,
    else one D2H pull (registered for next time)."""
    v = peek(x)
    if v is not None:
        return v
    h = np.asarray(x)
    register(x, h)
    return h


def clear() -> None:
    _CACHE.clear()
