"""Output manifest — the port's copy of what it uses of
``fastkmer_tpu.output.manifest``.

``write_manifest`` records the run config, per-bin files and row counts,
the sha256 of every file and a table checksum, so that ``verify_output``
can check a directory's completeness and content instead of inferring it
from "all B files appeared".  The JSON is the JAX package's, key for key.

A multi-rank run writes one ``write_manifest_shard`` per rank (the bins
that rank wrote) and rank 0 unites them with ``merge_manifest_shards``.

``write_table_sidecar`` keeps the final table beside the bin files, so a
repair rewrites damaged bins without recounting.  ``BatchCheckpointer``
persists partial tables with a cursor, so an interrupted job resumes from
its last checkpoint.  The on-disk formats (``table.npz``, ``cursor.json``,
``part*.npz``, ``spill*.npz``) are the JAX package's: a checkpoint
directory one package left behind resumes in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile

import numpy as np

MANIFEST = "manifest.json"


def table_checksum(words: np.ndarray, counts: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(words).tobytes())
    h.update(np.ascontiguousarray(counts.astype(np.int64)).tobytes())
    return h.hexdigest()


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(out_dir: str, cfg_dict: dict, words, counts, bins,
                   extra_files: dict | None = None,
                   bin_hashes: dict | None = None,
                   binary: bool = False) -> str:
    """``bin_hashes`` ({bin id: sha256 of the bin file}, from
    writer.write_bin_files) lets verify_output catch a changed byte at the
    same line count.  ``binary`` marks an enableKryo output whose data lives
    in npz artifacts (``extra_files``, name -> sha256) rather than text
    bins; the ``bins`` mapping then stays as row-count metadata."""
    os.makedirs(out_dir, exist_ok=True)
    uniq, idx = np.unique(bins, return_counts=True) if bins.size else ([], [])
    manifest = {
        "config": cfg_dict,
        "n_unique": int(words.shape[0]),
        "n_instances": int(counts.sum()),
        "checksum": table_checksum(words, counts),
        "bins": {int(b): int(c) for b, c in zip(uniq, idx)},
    }
    if binary:
        manifest["binary"] = True
    if bin_hashes is not None:
        manifest["bin_sha256"] = {int(b): h for b, h in bin_hashes.items()}
    if extra_files:
        manifest["extra_files"] = extra_files
    path = os.path.join(out_dir, MANIFEST)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def write_manifest_shard(out_dir: str, cfg_dict: dict, words, counts, bins,
                         process_index: int,
                         bin_hashes: dict | None = None,
                         extra_files: dict | None = None,
                         binary: bool = False) -> str:
    """A rank's manifest shard: only the bins it wrote (its shards'
    disjoint bin set), with their hashes and its extra artifacts; rank 0
    unites the shards with ``merge_manifest_shards`` after a barrier."""
    os.makedirs(out_dir, exist_ok=True)
    uniq, idx = np.unique(bins, return_counts=True) if bins.size else ([], [])
    shard = {
        "config": cfg_dict,
        "process_index": process_index,
        "n_unique": int(words.shape[0]),
        "n_instances": int(counts.sum()),
        "checksum": table_checksum(words, counts),
        "bins": {int(b): int(c) for b, c in zip(uniq, idx)},
    }
    if binary:
        shard["binary"] = True
    if bin_hashes is not None:
        shard["bin_sha256"] = {int(b): h for b, h in bin_hashes.items()}
    if extra_files:
        shard["extra_files"] = extra_files
    path = os.path.join(out_dir, f"manifest.part{process_index}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(shard, f, indent=2)
    os.replace(tmp, path)
    return path


def merge_manifest_shards(out_dir: str, n_processes: int) -> str:
    """Unite ``n_processes`` manifest shards into the directory manifest.
    The bin sets must be disjoint; the checksum hashes the shards' table
    checksums in rank order (no rank holds the whole table, so the
    directory cannot be repaired from a sidecar)."""
    shards = []
    for pidx in range(n_processes):
        with open(os.path.join(out_dir, f"manifest.part{pidx}.json")) as f:
            shards.append(json.load(f))
    bins: dict = {}
    bin_hashes: dict = {}
    extra_files: dict = {}
    for s in shards:
        overlap = set(bins) & set(s["bins"])
        if overlap:
            raise RuntimeError(
                f"manifest shards claim the same bins {sorted(overlap)[:8]}; "
                "per-process bin sets must be disjoint"
            )
        bins.update(s["bins"])
        bin_hashes.update(s.get("bin_sha256", {}))
        extra_files.update(s.get("extra_files", {}))
    h = hashlib.sha256()
    for s in shards:
        h.update(s["checksum"].encode())
    manifest = {
        "config": shards[0]["config"],
        "n_unique": sum(s["n_unique"] for s in shards),
        "n_instances": sum(s["n_instances"] for s in shards),
        "checksum": h.hexdigest(),
        "shards": [s["checksum"] for s in shards],
        "bins": {int(b): int(c) for b, c in bins.items()},
    }
    if any(s.get("binary") for s in shards):
        manifest["binary"] = True
    if bin_hashes:
        manifest["bin_sha256"] = {int(b): hh for b, hh in bin_hashes.items()}
    if extra_files:
        manifest["extra_files"] = extra_files
    path = os.path.join(out_dir, MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, path)
    return path


def verify_output(out_dir: str) -> dict:
    """Check every bin file recorded in the manifest: existence and content
    (sha256, or the line count for manifests without hashes), and every
    extra artifact by sha256.  Binary manifests carry no text bins.
    Returns {ok, missing, mismatched, extra_missing, extra_mismatched}."""
    with open(os.path.join(out_dir, MANIFEST)) as f:
        manifest = json.load(f)
    hashes = manifest.get("bin_sha256", {})
    missing, mismatched = [], []
    bins_to_check = {} if manifest.get("binary") else manifest["bins"]
    for b, n_rows in bins_to_check.items():
        p = os.path.join(out_dir, f"bin{b}")
        if not os.path.exists(p):
            missing.append(int(b))
            continue
        if b in hashes:
            if file_sha256(p) != hashes[b]:
                mismatched.append(int(b))
            continue
        data = open(p, "rb").read()
        if data.endswith(b"EOF"):
            data = data[:-3]
        if len(data.splitlines()) != n_rows:
            mismatched.append(int(b))
    extra_missing, extra_mismatched = [], []
    for name, digest in manifest.get("extra_files", {}).items():
        p = os.path.join(out_dir, name)
        if not os.path.exists(p):
            extra_missing.append(name)
        elif file_sha256(p) != digest:
            extra_mismatched.append(name)
    return {
        "ok": not missing and not mismatched
        and not extra_missing and not extra_mismatched,
        "missing": missing,
        "mismatched": mismatched,
        "extra_missing": extra_missing,
        "extra_mismatched": extra_mismatched,
    }


TABLE_SIDECAR = "table.npz"


def write_table_sidecar(out_dir: str, words, counts, bins) -> str:
    """Binary snapshot of the final table next to the bin files, so that
    repair_output can rewrite damaged bins with zero recounting.  Checked
    against the manifest checksum when loaded, so a stale or truncated
    sidecar never repairs with wrong counts."""
    path = os.path.join(out_dir, TABLE_SIDECAR)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file handle: savez would append .npz to a name
        np.savez(f, words=words, counts=counts, bins=bins)
    os.replace(tmp, path)  # atomic: never a truncated sidecar
    return path


def load_table_sidecar(out_dir: str):
    """-> (words, counts, bins) if a sidecar exists AND matches the
    manifest checksum, else None."""
    path = os.path.join(out_dir, TABLE_SIDECAR)
    if not os.path.exists(path):
        return None
    try:
        with open(os.path.join(out_dir, MANIFEST)) as f:
            manifest = json.load(f)
        with np.load(path) as z:
            words, counts, bins = z["words"], z["counts"], z["bins"]
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None  # unreadable: the repair recounts instead
    if table_checksum(words, counts) != manifest.get("checksum"):
        return None
    return words, counts, bins


class BatchCheckpointer:
    """Persist partial tables so that a job can resume mid-file.

    Two flows share the cursor file (the cursor is authoritative; part
    files past it are ignored, so a crash between a part write and the
    cursor rename is harmless):

    * per batch (``save_batch``): one npz per batch index, for the host
      path, where every batch's table visits the host anyway;
    * spills (``save_spills``): the device-accumulator paths checkpoint at
      merge boundaries by forcing a spill every ``interval`` batches and
      persisting the spill parts past the cursor's count and the batch
      cursor.  A resume loads
      the spills back and skips the covered batches; spilled parts merge by
      the same weighted group-by as live ones, so the table is exact.
    """

    def __init__(self, ckpt_dir: str, interval: int = 32):
        self.dir = ckpt_dir
        self.interval = interval
        os.makedirs(ckpt_dir, exist_ok=True)
        self.cursor_path = os.path.join(ckpt_dir, "cursor.json")

    def _cursor(self) -> dict:
        if not os.path.exists(self.cursor_path):
            return {"completed": 0, "spills": 0, "log": []}
        with open(self.cursor_path) as f:
            cur = json.load(f)
        cur.setdefault("spills", 0)
        cur.setdefault("log", [])
        return cur

    def _write_cursor(self, cur: dict) -> None:
        tmp = self.cursor_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cur, f)
        os.replace(tmp, self.cursor_path)  # atomic cursor update

    def completed_batches(self) -> int:
        return self._cursor()["completed"]

    def save_batch(self, index: int, words, counts, bins) -> None:
        np.savez(
            os.path.join(self.dir, f"part{index:06d}.npz"),
            words=words, counts=counts, bins=bins,
        )
        self._write_cursor({"completed": index + 1, "spills": 0})

    def save_spills(self, completed: int, parts: list) -> None:
        """Persist the tables of ``parts`` past the cursor's spill count as
        spill files and advance the cursor to ``completed`` batches.
        ``parts`` is every table the run holds, loaded ones first, so a run
        resumed from a per-batch directory persists its loaded parts as
        spills too.  The cursor keeps a log of every (completed, spills)
        pair, so a resume can roll back to an earlier cursor
        (``rollback_to``)."""
        cur = self._cursor()
        for i in range(cur["spills"], len(parts)):
            words, counts, bins = parts[i]
            np.savez(
                os.path.join(self.dir, f"spill{i:06d}.npz"),
                words=words, counts=counts, bins=bins,
            )
        entry = [completed, len(parts)]
        self._write_cursor(
            {"completed": entry[0], "spills": entry[1], "log": cur["log"] + [entry]}
        )

    def rollback_to(self, completed: int) -> int:
        """Discard checkpoint state past ``completed`` batches: truncate to
        the newest logged cursor entry with completed <= target (the zero
        state if none), delete the spill files beyond it, and return the
        batch count resumed from.  Processes of a multi-host job that crash
        between each other's cursor writes re-align on the minimum this way."""
        cur = self._cursor()
        if cur["completed"] <= completed:
            return cur["completed"]
        keep = [e for e in cur["log"] if e[0] <= completed]
        base = keep[-1] if keep else [0, 0]
        for i in range(base[1], cur["spills"]):
            p = os.path.join(self.dir, f"spill{i:06d}.npz")
            if os.path.exists(p):
                os.remove(p)
        self._write_cursor({"completed": base[0], "spills": base[1], "log": keep})
        return base[0]

    def load_parts(self) -> list:
        cur = self._cursor()
        if cur["spills"]:
            names = [f"spill{i:06d}.npz" for i in range(cur["spills"])]
        else:
            names = [f"part{i:06d}.npz" for i in range(cur["completed"])]
        parts = []
        for name in names:
            with np.load(os.path.join(self.dir, name)) as z:
                parts.append((z["words"], z["counts"], z["bins"]))
        return parts

    def clear(self) -> None:
        for f in os.listdir(self.dir):
            os.remove(os.path.join(self.dir, f))
