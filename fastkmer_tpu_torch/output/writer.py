"""Per-bin count-table output — the port's copy of what it uses of
``fastkmer_tpu.output.writer``.

Matches the reference's sort-path format (extractKXmers,
SparkBinKmerCounter.scala:550-606): one file ``<dir>/bin<binId>`` per
non-empty bin, lines ``<KMER>\\t<count>\\n`` in ascending k-mer order,
terminated by a literal ``EOF`` sentinel (no trailing newline).  The
reference's HT path (:711-735) writes no sentinel; the HT engine passes
``eof_sentinel=False`` for byte-level compatibility.  The
binary format (npz of packed words + counts) replaces the reference's Kryo
variant (:557-558, :580, :599-602).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core import bits
from . import manifest as manifest_mod
from . import npz


def _span(timer, name: str):
    """``timer.span(name)``, or no span without a timer."""
    return timer.span(name) if timer is not None else contextlib.nullcontext()


def write_bin_files(
    out_dir: str,
    words: np.ndarray,
    counts: np.ndarray,
    bins: np.ndarray,
    k: int,
    eof_sentinel: bool = True,
    clean: bool = True,
    timer=None,
) -> dict[int, str]:
    """Write unique k-mers grouped per bin, each file ending in ``EOF``
    when ``eof_sentinel``.  ``words`` rows must be in ascending k-mer order;
    a stable argsort on bins keeps that order within each bin.  Returns
    {bin id: sha256 of the file's bytes} for the manifest.

    With ``clean`` (the default), stale ``bin*`` files and binary
    ``counts*.npz`` artifacts of an earlier run into the same directory are
    removed first: the manifest only checks the artifacts of the new run.
    Partial rewrites (pipeline.repair_output) pass clean=False.

    A ``timer`` (utils.timing.StageTimer) gets two spans of the calling
    thread, ``text_group`` (the stable sort by bin, the gathers and the
    bins' bounds) and ``text_bins`` (the file pool, from its first bin to
    its last); the seconds the writer threads spent formatting, hashing
    and writing the files, summed over the bins, in its counters
    ``write_format_s``, ``write_hash_s`` and ``write_file_s``; and the
    files and bytes written, ``EOF`` included, in ``text_files`` and
    ``text_bytes``."""
    os.makedirs(out_dir, exist_ok=True)
    if clean:
        _clean_stale_outputs(out_dir)
    if words.shape[0] == 0:
        return {}
    with _span(timer, "text_group"):
        order = np.argsort(bins, kind="stable")
        bins_s = bins[order]
        words_s = words[order]
        counts_s = counts[order]
        uniq_bins, starts = np.unique(bins_s, return_index=True)
        bounds = np.append(starts, bins_s.shape[0])
        blist = uniq_bins.tolist()
    hashes: list[str | None] = [None] * len(blist)
    seconds = np.zeros((len(blist), 3))  # a bin's format, hash and file seconds
    sizes = np.zeros(len(blist), dtype=np.int64)  # a bin file's bytes

    def _write_one(bi: int) -> None:
        # the native formatter (ctypes) and the file writes release the GIL,
        # and bins are disjoint slices of read-only arrays
        t0 = time.perf_counter()
        lo, hi = bounds[bi], bounds[bi + 1]
        lines = _format_lines(words_s[lo:hi], counts_s[lo:hi], k)
        t1 = time.perf_counter()
        h = hashlib.sha256(lines)
        if eof_sentinel:
            h.update(b"EOF")
        hashes[bi] = h.hexdigest()
        t2 = time.perf_counter()
        with open(os.path.join(out_dir, f"bin{blist[bi]}"), "wb") as f:
            f.write(lines)
            if eof_sentinel:
                f.write(b"EOF")
        seconds[bi] = (t1 - t0, t2 - t1, time.perf_counter() - t2)
        sizes[bi] = len(lines) + (3 if eof_sentinel else 0)

    workers = min(8, os.cpu_count() or 1, len(blist))
    with _span(timer, "text_bins"):
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                list(ex.map(_write_one, range(len(blist))))
        else:
            for bi in range(len(blist)):
                _write_one(bi)
    if timer is not None:
        for name, s in zip(("write_format_s", "write_hash_s", "write_file_s"),
                           seconds.sum(0).tolist()):
            timer.count(name, s)
        timer.count("text_files", len(blist))
        timer.count("text_bytes", int(sizes.sum()))
    return {int(b): h for b, h in zip(blist, hashes)}


def _is_stale_output(name: str) -> bool:
    """Artifacts a fresh run must replace: text bins and binary npz
    outputs (counts.npz and per-process counts.part<N>.npz shards)."""
    return (
        (name.startswith("bin") and name[3:].isdigit())
        or name == "counts.npz"
        or (name.startswith("counts.part") and name.endswith(".npz"))
    )


def _clean_stale_outputs(out_dir: str) -> None:
    for name in os.listdir(out_dir):
        if _is_stale_output(name):
            os.remove(os.path.join(out_dir, name))


def clean_output_dir(out_dir: str) -> None:
    """Remove bin files, binary outputs and manifest shards from a shared
    output directory.  A multi-rank run calls this once (rank 0, before a
    barrier) instead of per-rank ``clean=True`` writes, which would remove
    what the other ranks already wrote."""
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(out_dir):
        if _is_stale_output(name) or (
            name.startswith("manifest.part") and name.endswith(".json")
        ):
            os.remove(os.path.join(out_dir, name))


def _format_lines(words: np.ndarray, counts: np.ndarray, k: int) -> bytes:
    from ..ingest import native

    if native.available():  # native one-pass decode+format (fkingest.cpp)
        return native.dump_lines(words, counts, k)
    kmers = bits.decode_words_batch(words, k)
    return b"".join(
        km + b"\t" + str(int(c)).encode() + b"\n" for km, c in zip(kmers, counts.tolist())
    )


def write_binary(out_dir: str, words: np.ndarray, counts: np.ndarray, bins: np.ndarray,
                 k: int, name: str = "counts.npz", clean: bool = True, timer=None,
                 device=None) -> str:
    """Binary output (enableKryo=1): the npz in place of the reference's
    Kryo variant, ``np.savez_compressed``'s container deflated on the card
    for a CUDA ``device``, else in blocks over the host's cores
    (npz.write_npz, which names its counters).  A multi-rank writer passes its
    own ``name`` shard (``counts.part<r>.npz``; the shards' bins are
    disjoint and their union is the table) with ``clean=False``, rank 0
    having cleaned the shared directory once (clean_output_dir).  ``clean``
    removes stale bin files and npz artifacts of an earlier run, as in
    write_bin_files."""
    os.makedirs(out_dir, exist_ok=True)
    if clean:
        _clean_stale_outputs(out_dir)
    path = os.path.join(out_dir, name)
    npz.write_npz(path, {"words": words, "counts": counts, "bins": bins, "k": np.int32(k)},
                  timer=timer, device=device)
    return path


def write_binary_with_manifest(out_dir: str, cfg_dict: dict, words, counts,
                               bins, k: int, extra_files: dict | None = None,
                               timer=None, device=None) -> str:
    """Binary output (enableKryo=1): counts.npz plus a binary-flagged
    manifest whose extra_files carry the npz hash and any caller extras
    ({name: sha256} of sibling artifacts, e.g. those a repair keeps).  A
    ``timer`` (utils.timing.StageTimer) gets the spans ``write_data`` (the
    npz; on a CUDA ``device`` with its children ``npz_encode`` and
    ``npz_file``), ``write_sha256`` (its hash) and ``write_manifest``."""
    with _span(timer, "write_data"):
        path = write_binary(out_dir, words, counts, bins, k, timer=timer, device=device)
    files = dict(extra_files or {})
    with _span(timer, "write_sha256"):
        files["counts.npz"] = manifest_mod.file_sha256(path)
    with _span(timer, "write_manifest"):
        manifest_mod.write_manifest(
            out_dir, cfg_dict, words, counts, bins, extra_files=files, binary=True,
        )
    return path


def read_bin_file(path: str) -> dict[str, int]:
    """Parse a bin file back into {kmer: count} (a trailing EOF is dropped)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.endswith(b"EOF"):
        data = data[:-3]
    out: dict[str, int] = {}
    for line in data.splitlines():
        if line:
            km, cnt = line.split(b"\t")
            out[km.decode()] = int(cnt)
    return out


def read_output_dir(out_dir: str) -> dict[int, dict[str, int]]:
    """Every ``bin<i>`` file of a directory -> {i: {kmer: count}}."""
    return {int(name[3:]): read_bin_file(os.path.join(out_dir, name))
            for name in os.listdir(out_dir) if name.startswith("bin")}
