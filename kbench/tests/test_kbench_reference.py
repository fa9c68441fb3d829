"""The generator, the plain reference and the comparison, on the CPU."""

from __future__ import annotations

import collections
import os

import numpy as np
import pytest
import torch

from kbench import compare, generate, reference, spec
from kbench.harness import is_correct
from kbench.tests.tiny import tiny_cell

SEED = 2**31 + 77  # more than 32 signed bits hold


def test_generator_counts_and_determinism():
    asm, reads = spec.traffic("genome_g16m"), spec.traffic("reads64x_g1m_err")
    assert generate.shape(asm) == (32, 524_288)
    assert generate.input_bases(asm) == 16_777_216
    assert generate.shape(reads) == (671_088, 100)
    assert generate.input_bases(reads) == 67_108_800
    small = dict(reads, genome_bases=50_000, coverage=8)
    a = generate.rows(small, SEED, "cpu")
    assert a.shape == (50_000 * 8 // 100, 100) and a.dtype == torch.uint8
    assert torch.equal(a, generate.rows(small, SEED, "cpu"))
    assert not torch.equal(a, generate.rows(small, SEED + 1, "cpu"))
    n_share = float((a == 4).double().mean())
    assert 0.0005 < n_share < 0.002
    rec = generate.fasta_bytes(a).numpy()
    assert rec.shape == (a.shape[0], 104)
    assert rec[0, :3].tobytes() == b">r\n" and rec[0, -1] == ord("\n")


def test_reads_carry_substitutions():
    """Error-free reads of a genome hold only its windows; with
    substitutions about sub_rate of the bases differ from the genome."""
    tr = dict(spec.traffic("reads64x_g1m_err"), genome_bases=20_000, coverage=10,
              n_rate=0.0, reverse_share=0.0)
    clean = generate.rows(dict(tr, sub_rate=0.0), SEED, "cpu")
    noisy = generate.rows(tr, SEED, "cpu")
    share = float((clean != noisy).double().mean())
    assert 0.0015 < share < 0.0035
    assert int(noisy.max()) <= 3


def test_assembly_records_gaps_and_lines():
    tr = dict(spec.traffic("genome_g16m"), genome_bases=64_000, records=4, n_rate=0.02)
    a = generate.rows(tr, SEED, "cpu")
    assert a.shape == (4, 16_000)
    n = (a == 4).numpy()
    assert 0.01 < n.mean() < 0.03
    # N comes in runs of n_run: every run starts a gap of that length, or
    # two gaps overlap, or the record ends
    edges = np.diff(np.pad(n.astype(np.int8), ((0, 0), (1, 1))), axis=1)
    for row in edges:
        starts, ends = np.flatnonzero(row == 1), np.flatnonzero(row == -1)
        assert ((ends - starts >= tr["n_run"]) | (ends == a.shape[1])).all()
    rec = generate.fasta_bytes(a, 60).numpy()
    text = rec[0].tobytes()
    lines = text.split(b"\n")
    assert lines[0] == b">r" and lines[-1] == b""
    body = lines[1:-1]
    assert all(len(x) == 60 for x in body[:-1]) and len(body[-1]) == 16_000 % 60
    assert b"".join(body) == bytes(b"ACGTN"[c] for c in a[0].tolist())


def _oracle(reads: np.ndarray, k: int) -> collections.Counter:
    comp = str.maketrans("ACGT", "TGCA")
    c = collections.Counter()
    for row in reads:
        s = "".join("ACGTN"[x] for x in row)
        for i in range(len(s) - k + 1):
            w = s[i:i + k]
            if "N" not in w:
                c[min(w, w.translate(comp)[::-1])] += 1
    return c


@pytest.mark.parametrize("k", [13, 28, 32, 55])
def test_reference_count_matches_string_oracle(k):
    tr = dict(spec.traffic("reads64x_g1m_err"), genome_bases=3000, coverage=2,
              read_len=150, n_rate=0.01, sub_rate=0.01)
    codes = generate.rows(tr, SEED, "cpu")
    t = reference.count(codes, k)
    got = {"".join("ACGT"[x] for x in row): int(n)
           for row, n in zip(reference.codes_of(t.words, k).tolist(), t.counts.tolist())}
    assert got == dict(_oracle(codes.numpy(), k))
    keys = list(got)
    assert keys == sorted(keys)  # ascending k-mers


def _run_cli(cell, tmp, seed=SEED):
    from kbench.harness import Jobs

    job = spec.job_of(cell.config["argv"])
    codes = generate.rows(cell.traffic, seed, "cpu")
    fa = os.path.join(tmp, "reads.fa")
    generate.write_fasta(fa, generate.fasta_bytes(codes, cell.traffic["line_width"]).numpy())
    out = os.path.join(tmp, "out") + os.sep
    argv = spec.fill_argv(cell.config["argv"], input=fa, output=out, **cell.traffic)
    Jobs(argv + ["--device", "cpu"], os.path.join(tmp, "s.json"))()
    table = reference.count(codes, job.k)
    bins = reference.bins(table.words, job.k, job.m, job.b)
    return job, job.output_dir(out), table, bins, compare.expected_config(job, fa, out)


@pytest.mark.parametrize("config", ["fastkmer_k28_text", "kmc2_k55_bin"])
def test_reference_agrees_with_cli_on_cpu(config, tmp_path):
    job, out_dir, table, bins, cfg = _run_cli(tiny_cell(config), str(tmp_path))
    checks = _check(out_dir, job, table, bins, cfg)
    assert checks == {"bytes_off": 0, "manifest_off": 0}
    assert table.words.shape[0] > 1000


def _check(out_dir, job, table, bins, cfg):
    return compare.check_output(compare.snapshot(out_dir), job, table.words, table.counts,
                                bins, cfg)


def _known_good(config, tmp):
    cell = tiny_cell(config)
    job = spec.job_of(cell.config["argv"])
    codes = generate.rows(cell.traffic, SEED, "cpu")
    table = reference.count(codes, job.k)
    bins = reference.bins(table.words, job.k, job.m, job.b)
    out_dir = os.path.join(tmp, "good")
    cfg = compare.expected_config(job, "in.fa", tmp)
    reference.write_output(out_dir, job, table.words, table.counts, bins, cfg)
    return job, out_dir, table, bins, cfg


def _text_lines(path):
    data = open(path, "rb").read()
    assert data.endswith(b"EOF")
    return data[:-3].splitlines(keepends=True)


def _write_lines(path, lines):
    with open(path, "wb") as f:
        f.write(b"".join(lines) + b"EOF")


def _two_bins(out_dir):
    names = sorted(n for n in os.listdir(out_dir) if n.startswith("bin"))
    return os.path.join(out_dir, names[0]), os.path.join(out_dir, names[1])


def test_known_good_directory_passes(tmp_path):
    for config in ("fastkmer_k28_text", "kmc2_k55_bin"):
        job, out_dir, table, bins, cfg = _known_good(config, str(tmp_path / config))
        checks = _check(out_dir, job, table, bins, cfg)
        assert checks == dict.fromkeys(checks, 0)


def test_text_count_changed_fails(tmp_path):
    job, out_dir, table, bins, cfg = _known_good("fastkmer_k28_text", str(tmp_path))
    a, _ = _two_bins(out_dir)
    lines = _text_lines(a)
    km, n = lines[0].rstrip(b"\n").split(b"\t")
    lines[0] = km + b"\t" + str(int(n) + 1).encode() + b"\n"
    _write_lines(a, lines)
    c = _check(out_dir, job, table, bins, cfg)
    assert c == {"bytes_off": 1, "manifest_off": 0} and not is_correct(dict(c, jobs_off=0))


def test_text_kmer_dropped_fails(tmp_path):
    job, out_dir, table, bins, cfg = _known_good("fastkmer_k28_text", str(tmp_path))
    a, _ = _two_bins(out_dir)
    lines = _text_lines(a)
    _write_lines(a, lines[1:])
    c = _check(out_dir, job, table, bins, cfg)
    assert c == {"bytes_off": 1, "manifest_off": 0}


def test_text_bin_moved_fails(tmp_path):
    job, out_dir, table, bins, cfg = _known_good("fastkmer_k28_text", str(tmp_path))
    a, b = _two_bins(out_dir)
    la, lb = _text_lines(a), _text_lines(b)
    _write_lines(a, la[1:])
    _write_lines(b, sorted(lb + la[:1]))
    c = _check(out_dir, job, table, bins, cfg)
    assert c == {"bytes_off": 2, "manifest_off": 0}


def test_text_missing_eof_and_stray_file_fail(tmp_path):
    job, out_dir, table, bins, cfg = _known_good("fastkmer_k28_text", str(tmp_path))
    a, _ = _two_bins(out_dir)
    data = open(a, "rb").read()
    open(a, "wb").write(data[:-3])
    open(os.path.join(out_dir, "stray"), "wb").write(b"x")
    c = _check(out_dir, job, table, bins, cfg)
    assert c == {"bytes_off": 2, "manifest_off": 0}


@pytest.mark.parametrize("fault", ["count", "drop", "bin"])
def test_binary_table_changes_fail(fault, tmp_path):
    job, out_dir, table, bins, cfg = _known_good("kmc2_k55_bin", str(tmp_path))
    path = os.path.join(out_dir, "counts.npz")
    with np.load(path) as z:
        m = {n: z[n].copy() for n in z.files}
    if fault == "count":
        m["counts"][3] += 1
    elif fault == "drop":
        m = dict(m, words=m["words"][1:], counts=m["counts"][1:], bins=m["bins"][1:])
    else:
        m["bins"][3] = (m["bins"][3] + 1) % job.b
    np.savez_compressed(path, **m)
    c = _check(out_dir, job, table, bins, cfg)
    assert c["bytes_off"] == (3 if fault == "drop" else 1) and c["manifest_off"] >= 1


def test_control_fails_the_comparison(tmp_path):
    """The fingerprint-keyed control, at a size with some hundred thousand
    distinct k-mers (tens of expected 31-bit collisions), is not correct by
    the run's own limits."""
    from kbench.control import control_checks

    cell = tiny_cell("fastkmer_k28_text", genome=500_000)
    c = control_checks(cell, SEED, "cpu", str(tmp_path))
    assert c["distinct_control"] < c["distinct_exact"]
    assert c["bytes_off"] > 0 and c["manifest_off"] > 0
    assert is_correct(c) is False


def test_manifest_field_changed_fails(tmp_path):
    import json

    job, out_dir, table, bins, cfg = _known_good("fastkmer_k28_text", str(tmp_path))
    path = os.path.join(out_dir, "manifest.json")
    man = json.load(open(path))
    man["n_instances"] += 1
    man["config"]["k"] = 27
    json.dump(man, open(path, "w"))
    c = _check(out_dir, job, table, bins, cfg)
    assert c["manifest_off"] == 2 and c["bytes_off"] == 0
