"""Hold a count job's output directory against the reference.

Every number is a count of differences, with the limit 0: the job is
exact or it is wrong.

* ``bytes_off``: files (text) or npz members (binary) whose bytes differ
  from what the reference renders, or that are missing or unexpected.  A
  text line carries its k-mer and count and a file its bin, and the npz
  members are the words, counts and bins, so a k-mer missing, extra,
  miscounted or in another bin changes some file;
* ``manifest_off``: manifest fields that differ from the reference's
  (rows, instances, checksum, rows and sha256 a bin or the npz's),
  including the config fields the job's argv sets.
"""

from __future__ import annotations

import hashlib
import io
import json
import os

import numpy as np

from . import reference


def snapshot(out_dir: str) -> dict:
    """{file name: uint8 array of its bytes} of an output directory."""
    if not os.path.isdir(out_dir):
        return {}
    return {e.name: np.fromfile(e.path, np.uint8) for e in os.scandir(out_dir) if e.is_file()}


def expected_config(job, dataset: str, output: str) -> dict:
    """The manifest's config fields that the argv sets."""
    return {
        "dataset": dataset, "output_directory": output, "k": job.k, "m": job.m,
        "x": job.x, "max_b": job.max_b, "sequence_type": job.sequence_type,
        "write": job.write, "use_kryo_serializer": job.binary, "use_ht": job.use_ht,
        "prefix": job.prefix, "reads_per_batch": job.reads_per_batch,
        "read_len": job.read_len,
    }


def _manifest_off(data, expected: dict, config: dict) -> int:
    try:
        man = json.loads(data.tobytes())
    except (AttributeError, ValueError):
        return len(expected) + len(config)
    if not isinstance(man, dict):
        return len(expected) + len(config)
    off = sum(man.get(key) != val for key, val in expected.items())
    off += sum(key not in expected for key in man if key != "config")
    got = man.get("config") if isinstance(man.get("config"), dict) else {}
    off += sum(got.get(key) != val for key, val in config.items())
    return int(off)


def check_output(files: dict, job, ref_words, ref_counts, ref_bins, config: dict) -> dict:
    """Every number of the module docstring, for one output directory's
    ``snapshot``."""
    hw = ref_words.cpu().numpy().astype(np.uint32)
    hc = ref_counts.cpu().numpy().astype(np.int64)
    hb = ref_bins.cpu().numpy().astype(np.int32)
    text = npz_sha = None
    if job.binary:
        expect_files = {"counts.npz", "manifest.json"}
        want = {"words": hw, "counts": hc, "bins": hb, "k": np.int32(job.k)}
        got = {}
        if "counts.npz" in files:
            raw = files["counts.npz"].tobytes()
            npz_sha = hashlib.sha256(raw).hexdigest()
            with np.load(io.BytesIO(raw), allow_pickle=False) as z:
                got = {name: z[name] for name in z.files}
        bytes_off = sum(name not in got or got[name].dtype != arr.dtype
                        or not np.array_equal(got[name], arr) for name, arr in want.items())
        bytes_off += sum(name not in want for name in got)
    else:
        text = reference.render_text(ref_words, ref_counts, ref_bins, job.k)
        expect_files = {f"bin{b}" for b in text.spans} | {"manifest.json"}
        bytes_off = 0
        for b, (off, n) in text.spans.items():
            data = files.get(f"bin{b}")
            bytes_off += not (data is not None and data.size == n + 3
                              and data[n:].tobytes() == b"EOF"
                              and np.array_equal(data[:n], text.data[off:off + n]))
    bytes_off += len(set(files) - expect_files)
    expected = reference.expected_manifest(job, hw, hc, hb, text, npz_sha)
    return {"bytes_off": int(bytes_off),
            "manifest_off": _manifest_off(files.get("manifest.json"), expected, config)}
