"""The binary output's npz, deflated in blocks on every core the process
may use.

``write_npz`` writes the container ``np.savez_compressed`` writes: a zip
of one ``<name>.npy`` member an array, in the order given, each DEFLATED
at zlib's default level (6) with zip64 extras and the 1980-01-01 time
``zipfile`` gives a member opened by name, each member's bytes the
``.npy`` header of ``np.lib.format`` then the array's own buffer.
``zipfile``, and so ``np.load``, read it as they read numpy's.

A member's deflate stream is cut as pigz cuts it: blocks of ``BLOCK``
input bytes (the first also holds the ``.npy`` header), each deflated
raw on its own, primed with the ``WINDOW`` bytes before it as the
dictionary and ended with a sync flush, the member's last with a finish,
so that the blocks laid end to end are one deflate stream.  zlib releases
the interpreter lock while it deflates, so a thread pool runs the blocks
on as many cores as there are blocks.  ``BLOCK`` is a constant: the file's
bytes do not depend on how many cores the host has.
"""

from __future__ import annotations

import collections
import contextlib
import io
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BLOCK = 1 << 20  # input bytes a deflate block
WINDOW = 1 << 15  # deflate's window: the dictionary a block is primed with

_VERSION = 45  # zip64
_DEFLATED = 8
_DOSDATE = (1980 - 1980) << 9 | 1 << 5 | 1  # 1980-01-01, 00:00:00 (time 0)
_UNIX = 3  # the system zipfile names as a member's creator off Windows
_MASKED = 0xFFFFFFFF  # a 32-bit field whose value is in the zip64 extra


def _member(array) -> tuple[bytes, memoryview]:
    """A member's ``.npy`` header and the array's bytes, C order."""
    a = np.asarray(array, order="C")
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(head, np.lib.format.header_data_from_array_1_0(a))
    return head.getvalue(), memoryview(a.reshape(-1).view(np.uint8))


def _deflate(parts, zdict, last: bool) -> bytes:
    c = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED, -15,
                         **({} if zdict is None else {"zdict": zdict}))
    out = [c.compress(p) for p in parts]
    out.append(c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH))
    return b"".join(out)


def _crc(head: bytes, data: memoryview) -> int:
    return zlib.crc32(data, zlib.crc32(head))


def _blocks(head: bytes, data: memoryview) -> list[tuple]:
    """The member's blocks as ``_deflate`` arguments, in stream order."""
    n = max(1, -(-len(data) // BLOCK))
    return [((head, data[:BLOCK]) if i == 0 else (data[i * BLOCK:(i + 1) * BLOCK],),
             None if i == 0 else data[i * BLOCK - WINDOW:i * BLOCK], i == n - 1)
            for i in range(n)]


def _local_header(name: bytes, crc: int, size: int, csize: int) -> bytes:
    """50 bytes and the name: the fixed part, the name, the zip64 extra."""
    return (struct.pack("<4s2B4HL2L2H", b"PK\x03\x04", _VERSION, 0, 0, _DEFLATED, 0,
                        _DOSDATE, crc, _MASKED, _MASKED, len(name), 20)
            + name + struct.pack("<2H2Q", 1, 16, size, csize))


def _central_entry(name: bytes, crc: int, size: int, csize: int, offset: int) -> bytes:
    return (struct.pack("<4s4B4HL2L5H2L", b"PK\x01\x02", _VERSION, _UNIX, _VERSION, 0, 0,
                        _DEFLATED, 0, _DOSDATE, crc, _MASKED, _MASKED, len(name), 28,
                        0, 0, 0, 0, _MASKED)
            + name + struct.pack("<2H3Q", 1, 24, size, csize, offset))


def _end_records(count: int, start: int, end: int) -> bytes:
    """The zip64 end record and its locator, then the end record, for a
    central directory of ``count`` entries from ``start`` to ``end``."""
    size = end - start
    return (struct.pack("<4sQ2H2L4Q", b"PK\x06\x06", 44, _VERSION, _VERSION, 0, 0,
                        count, count, size, start)
            + struct.pack("<4sLQL", b"PK\x06\x07", 0, end, 1)
            + struct.pack("<4s4H2LH", b"PK\x05\x06", 0, 0, min(count, 0xFFFF),
                          min(count, 0xFFFF), min(size, _MASKED), min(start, _MASKED), 0))


def write_npz(path: str, arrays: dict, timer=None) -> None:
    """Write ``arrays`` ({name: array}) to ``path`` as
    ``np.savez_compressed`` would, the deflate spread over a thread pool
    sized from ``os.sched_getaffinity`` and capped at the blocks of the
    members that have more than one; a member of one block is deflated on
    the calling thread.  A ``timer`` (utils.timing.StageTimer) counts
    ``write_blocks`` (deflate blocks written) and ``write_threads`` (the
    pool's workers, 1 without a pool)."""
    members = [(f"{name}.npy".encode(), *_member(a)) for name, a in arrays.items()]
    blocks = [_blocks(head, data) for _, head, data in members]
    pooled = sum(len(b) for b in blocks if len(b) > 1)
    workers = min(len(os.sched_getaffinity(0)), pooled)
    entries = []
    with open(path, "wb") as f, (ThreadPoolExecutor(workers) if workers > 1
                                 else contextlib.nullcontext()) as pool:
        # every block is queued before the first is written, so the pool
        # runs on across the members while the file takes them in order
        queued = [collections.deque([pool.submit(_crc, head, data)]
                                    + [pool.submit(_deflate, *b) for b in bl])
                  if pool is not None and len(bl) > 1 else None
                  for (_, head, data), bl in zip(members, blocks)]
        for (name, head, data), bl, q in zip(members, blocks, queued):
            offset = f.tell()
            f.write(_local_header(name, 0, 0, 0))  # rewritten once the sizes are known
            if q is None:
                for b in bl:
                    f.write(_deflate(*b))
                crc = _crc(head, data)
            else:
                crc = q.popleft()
                while q:
                    f.write(q.popleft().result())
                crc = crc.result()
            end = f.tell()
            size, csize = len(head) + len(data), end - offset - 50 - len(name)
            f.seek(offset)
            f.write(_local_header(name, crc, size, csize))
            f.seek(end)
            entries.append(_central_entry(name, crc, size, csize, offset))
        start = f.tell()
        f.write(b"".join(entries))
        f.write(_end_records(len(entries), start, f.tell()))
    if timer is not None:
        timer.count("write_blocks", sum(len(b) for b in blocks))
        timer.count("write_threads", max(workers, 1))
