"""The port's native dense packer (``ingest.native.pack_dense``, reached
through ``ingest.batch.batch_file``'s native route) against the JAX
package's ``batch_file`` and against the port's python route, byte for
byte: every batch's codes, ``n_reads`` and ``n_bases``, and the number of
batches.

Each case names the references that define its input: the python parser
reads no headerless FASTA and cannot chunk at a stride below k+1
(``fasta.chunk_sequence`` wants read_len >= 2k), so those cases are held
against the JAX package's native route alone."""

import gzip

import numpy as np
import pytest

pytest.importorskip("torch")

from fastkmer_tpu.ingest import batch as jbatch  # noqa: E402
from fastkmer_tpu_torch.ingest import batch as tbatch  # noqa: E402
from fastkmer_tpu_torch.ingest import native as tnative  # noqa: E402


def _reads(seed: int, lengths, alphabet="ACGT") -> list[str]:
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(alphabet), size=n)) for n in lengths]


def _with_n_runs(seed: int) -> list[str]:
    reads = _reads(seed, [90, 300, 7, 64, 150, 33] * 4, "ACGTN")
    return [r[:10] + "N" * 25 + r[35:] if len(r) > 40 else "N" * len(r) for r in reads]


# name -> (reads, k, R, L, file kind, sequence type, python route defined)
CASES = {
    # a 3,000-base record cut into chunks that run across several batches
    "batch_boundary": (_reads(1, [40, 3000, 25, 61, 3000]), 21, 2, 128, "fasta", 1, True),
    # 31 + 1 + 32 fills a 64-cell row exactly; 31 + 1 + 31 leaves it at L-1
    "exact_rows": (_reads(2, [31, 32, 31, 31, 5, 31, 32, 63, 64, 1] * 3), 13, 3, 64,
                   "fasta", 0, True),
    "reads_of_read_len": (_reads(3, [64] * 11 + [63, 65, 64]), 21, 4, 64, "fasta", 0, True),
    # empty records first, between reads, in runs, at a full row and last
    "zero_length": (_reads(4, [0, 0, 20, 0, 31, 32, 0, 64, 0, 0, 17, 0, 40, 23, 0]), 9, 2, 64,
                    "fasta", 0, True),
    "zero_length_only": (_reads(5, [0] * 7), 9, 2, 64, "fasta", 0, True),
    "headerless": (_reads(6, [1000]), 21, 3, 128, "headerless", 0, False),
    "n_runs": (_with_n_runs(7), 28, 3, 256, "fasta", 0, True),
    "fastq": (_reads(8, [100, 250, 0, 64, 300, 12] * 5), 28, 4, 128, "fastq", 0, True),
    "gzip": (_with_n_runs(9), 28, 3, 256, "gzip", 1, True),
    # stride L-(k-1) = 1: one new window a chunk
    "stride_1": (_reads(10, [40, 80, 33, 200, 32]), 32, 3, 32, "fasta", 0, False),
    # stride L-(k-1) = k+1: the smallest read_len the python chunker takes
    "stride_k_plus_1": (_reads(11, [40, 95, 120, 57, 300]), 28, 3, 56, "fasta", 1, True),
    # lengths 0, L-1, L, L+1 and up to 3L in a random order, many records a row
    "mixed_lengths": (_reads(13, np.random.default_rng(13).choice(
        [0, 1, 47, 48, 49, 5, 12, 100, 144], size=120)), 17, 3, 48, "fasta", 0, True),
    # the benchmark's cell in small: 100-base reads, 40 a 4096-cell row, k=55
    "cell_shape": (_reads(12, [100] * 700), 55, 4, 4096, "fasta", 0, True),
}


def _write(tmp_path, reads: list[str], kind: str) -> str:
    if kind == "headerless":
        path = tmp_path / "in.fa"
        path.write_text("\n".join(r[j:j + 70] for r in reads for j in range(0, len(r), 70)) + "\n")
    elif kind == "fastq":
        path = tmp_path / "in.fq"
        path.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n" for i, r in enumerate(reads)))
    else:
        text = "".join(f">r{i} d\n" + "".join(r[j:j + 60] + "\n" for j in range(0, len(r), 60))
                       for i, r in enumerate(reads))
        path = tmp_path / ("in.fa.gz" if kind == "gzip" else "in.fa")
        if kind == "gzip":
            with gzip.open(path, "wt") as f:
                f.write(text)
        else:
            path.write_text(text)
    return str(path)


@pytest.mark.parametrize("case", list(CASES))
def test_native_pack_is_the_jax_one(tmp_path, case):
    reads, k, R, L, kind, seq_type, python_route = CASES[case]
    path = _write(tmp_path, reads, kind)
    args = (path, seq_type, k, R, L)
    got = list(tbatch.batch_file(*args, use_native=True))
    refs = [jbatch.batch_file(*args, use_native=True)]
    if python_route:
        refs += [jbatch.batch_file(*args, use_native=False),
                 tbatch.batch_file(*args, use_native=False)]
    assert got
    for ref in refs:
        want = list(ref)
        assert len(got) == len(want)
        for (gc, gr, gb), (wc, wr, wb) in zip(got, want):
            assert gc.shape == wc.shape == (R, L) and gc.dtype == wc.dtype == np.uint8
            np.testing.assert_array_equal(gc, wc)
            assert (gr, gb) == (wr, wb)
    # each batch is a buffer of its own
    assert len({codes.ctypes.data for codes, _, _ in got}) == len(got)


def test_native_pack_needs_a_stride():
    """A record longer than read_len with k > read_len has no stride to be
    cut at: the native packer raises; a short record still packs."""
    codes = np.zeros(50, dtype=np.uint8)
    cursor = np.zeros(2, dtype=np.int64)
    out = np.empty((2, 40), dtype=np.uint8)
    with pytest.raises(ValueError, match="stride"):
        tnative.pack_dense(codes, np.array([0, 50]), 45, out, cursor)
    cursor[:] = 0
    assert tnative.pack_dense(codes, np.array([0, 30, 50]), 45, out, cursor) == (2, 50)
    want = np.full((2, 40), 4, dtype=np.uint8)
    want[0, :30] = want[1, :20] = 0  # 30 + 1 + 20 > 40: the second opens row 1
    np.testing.assert_array_equal(out, want)
    assert cursor.tolist() == [2, 0]
    assert tnative.pack_dense(codes, np.array([0, 30, 50]), 45, out, cursor) == (0, 0)
    for bad in (np.empty((0, 40), np.uint8), np.empty((2, 40), np.int8), out[:, ::2]):
        with pytest.raises(ValueError, match="uint8"):
            tnative.pack_dense(codes, np.array([0, 30, 50]), 45, bad, cursor)
