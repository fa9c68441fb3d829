"""Output manifest — the port's copy of what it uses of
``fastkmer_tpu.output.manifest``.

``write_manifest`` records the run config, per-bin files and row counts,
the sha256 of every file and a table checksum, so that ``verify_output``
can check a directory's completeness and content instead of inferring it
from "all B files appeared".  The JSON is the JAX package's, key for key.
"""

from __future__ import annotations

import hashlib
import json
import os

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
