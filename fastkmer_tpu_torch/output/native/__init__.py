"""ctypes bindings for the native k-way merge (fkmerge.cpp) — the port's
copy of ``fastkmer_tpu.output.native``.

Built with g++ at first use into ``build/fastkmer_tpu_torch/``
(utils.nativebuild).  The numpy path in pipeline.merge_partials stays the
semantic reference; the tests hold both to identical outputs.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ...utils import nativebuild

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fkmerge.cpp")


@functools.cache
def _load():
    so = nativebuild.build("fkmerge", _SRC)
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.fk_merge.restype = ctypes.c_int64
    lib.fk_merge.argtypes = [
        ctypes.POINTER(u32p), ctypes.POINTER(i64p), ctypes.POINTER(i32p),
        i64p, ctypes.c_int64, ctypes.c_int64, u32p, i64p, i32p,
    ]
    return lib


def merge_sorted_parts(parts: list, W: int):
    """K-way merge of [(words [n,W] u32 ascending-unique, counts i64,
    bins i32), ...] -> (words, counts, bins) with equal keys summed.
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    P = len(parts)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    wp = (u32p * P)()
    cp = (i64p * P)()
    bp = (i32p * P)()
    sizes = (ctypes.c_int64 * P)()
    keep = []  # hold contiguous buffers alive through the call
    total = 0
    for i, (w, c, b) in enumerate(parts):
        w = np.ascontiguousarray(w, dtype=np.uint32)
        c = np.ascontiguousarray(c, dtype=np.int64)
        b = np.ascontiguousarray(b, dtype=np.int32)
        keep.append((w, c, b))
        wp[i] = w.ctypes.data_as(u32p)
        cp[i] = c.ctypes.data_as(i64p)
        bp[i] = b.ctypes.data_as(i32p)
        sizes[i] = w.shape[0]
        total += w.shape[0]
    ow = np.empty((total, W), np.uint32)
    oc = np.empty(total, np.int64)
    ob = np.empty(total, np.int32)
    n = lib.fk_merge(
        wp, cp, bp, sizes, P, W,
        ow.ctypes.data_as(u32p), oc.ctypes.data_as(i64p), ob.ctypes.data_as(i32p),
    )
    return ow[:n], oc[:n], ob[:n]
