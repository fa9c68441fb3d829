"""The binary output's npz, deflated on the card for a CUDA device and in
blocks on every core the process may use for the CPU.

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

On a CUDA device the members are deflated on the card instead
(``cuda_deflate``: 64 KiB segments, each matching into the 32 KiB before
it, and a CRC-32 computed there), and the host only lays out the same
container around the bytes that come back.  The two paths share the
container and nothing of the deflate; each one's bytes depend on the table
alone.
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
import torch

from . import cuda_deflate

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


class _Zip:
    """The container, written in stream order: ``start`` opens a member
    (its local header, completed at the end), its deflate bytes follow with
    ``write``, and ``close`` with each member's CRC-32 fills the headers in
    and writes the central directory and the end records."""

    def __init__(self, f) -> None:
        self.f, self.members = f, []  # (name, uncompressed size, header offset)

    def start(self, name: bytes, size: int) -> None:
        self.members.append((name, size, self.f.tell()))
        self.f.write(_local_header(name, 0, 0, 0))

    def write(self, data) -> None:
        self.f.write(data)

    def close(self, crcs: list) -> None:
        end = self.f.tell()
        ends = [offset for _, _, offset in self.members[1:]] + [end]
        entries = []
        for (name, size, offset), stop, crc in zip(self.members, ends, crcs):
            csize = stop - offset - 50 - len(name)
            self.f.seek(offset)
            self.f.write(_local_header(name, crc, size, csize))
            entries.append(_central_entry(name, crc, size, csize, offset))
        self.f.seek(end)
        self.f.write(b"".join(entries))
        self.f.write(_end_records(len(entries), end, self.f.tell()))


def write_npz(path: str, arrays: dict, timer=None, device=None) -> None:
    """Write ``arrays`` ({name: array}) to ``path`` in
    ``np.savez_compressed``'s container.  On a CUDA ``device`` the members
    are deflated on the card (``_write_card``); otherwise (None or the CPU)
    on a thread pool sized from ``os.sched_getaffinity`` and capped at the
    blocks of the members that have more than one, a member of one block
    on the calling thread.  A ``timer`` (utils.timing.StageTimer) counts
    ``write_card_segments`` (segments deflated on the card, 0 here) and,
    on the host, ``write_blocks`` (deflate blocks written) and
    ``write_threads`` (the pool's workers, 1 without a pool)."""
    members = [(f"{name}.npy".encode(), *_member(a)) for name, a in arrays.items()]
    if device is not None and torch.device(device).type == "cuda":
        _write_card(path, members, timer, torch.device(device))
        return
    blocks = [_blocks(head, data) for _, head, data in members]
    pooled = sum(len(b) for b in blocks if len(b) > 1)
    workers = min(len(os.sched_getaffinity(0)), pooled)
    crcs = []
    with open(path, "wb") as f, (ThreadPoolExecutor(workers) if workers > 1
                                 else contextlib.nullcontext()) as pool:
        # every block is queued before the first is written, so the pool
        # runs on across the members while the file takes them in order
        queued = [collections.deque([pool.submit(_crc, head, data)]
                                    + [pool.submit(_deflate, *b) for b in bl])
                  if pool is not None and len(bl) > 1 else None
                  for (_, head, data), bl in zip(members, blocks)]
        z = _Zip(f)
        for (name, head, data), bl, q in zip(members, blocks, queued):
            z.start(name, len(head) + len(data))
            if q is None:
                for b in bl:
                    z.write(_deflate(*b))
                crcs.append(_crc(head, data))
            else:
                crc = q.popleft()
                while q:
                    z.write(q.popleft().result())
                crcs.append(crc.result())
        z.close(crcs)
    if timer is not None:
        timer.count("write_card_segments", 0)
        timer.count("write_blocks", sum(len(b) for b in blocks))
        timer.count("write_threads", max(workers, 1))


def _write_card(path: str, members: list, timer, device: torch.device) -> None:
    """``write_npz`` on the card.  The pieces come back in stream order
    while the card codes the next, and each is written as it comes: the
    spans ``npz_encode`` (the host's copies in, launches and waits for the
    card's bytes, the last ending in a synchronize) and ``npz_file`` (the
    file's writes) alternate.  Counts ``write_card_segments`` and
    ``write_stored_segments`` (segments the stored form was shorter for)."""

    def span(name: str):
        return timer.span(name) if timer is not None else contextlib.nullcontext()

    stream = cuda_deflate.deflate_stream([(head, data) for _, head, data in members], device)
    with open(path, "wb") as f:
        z = _Zip(f)
        while True:
            with span("npz_encode"):
                m, got = next(stream)
                if m is None:
                    torch.cuda.synchronize(device)
            with span("npz_file"):
                if m is None:
                    z.close([crc for crc, _, _ in got])
                    break
                if m == len(z.members):  # the member's first bytes
                    name, head, data = members[m]
                    z.start(name, len(head) + len(data))
                z.write(got)
    if timer is not None:
        timer.count("write_card_segments", sum(segs for _, segs, _ in got))
        timer.count("write_stored_segments", sum(stored for _, _, stored in got))
