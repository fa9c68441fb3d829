"""``python -m fastkmer_tpu_torch.cli`` vs ``python -m fastkmer_tpu.cli``:
the same 13 positionals produce the same bytes, with ``--multiseq`` too
(one device and ``--mesh 4``); a flag without effect on the selected path
raises with the JAX CLI's error, and the ported ones leave their
artifacts; ``--device cuda`` without a card raises.  The mesh CLI
(``--mesh N --smer-transport``) is held against the JAX CLI by
``test_torch_mesh_cli.py``."""

import json
import os

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch  # noqa: E402

from fastkmer_tpu import cli as jcli  # noqa: E402
from fastkmer_tpu_torch import api as tapi  # noqa: E402
from fastkmer_tpu_torch import cli as tcli  # noqa: E402

from .golden.make_golden import B, K, M  # noqa: E402
from .test_torch_pipeline import mixed_reads  # noqa: E402
from .test_pipeline_e2e import write_fasta  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_FA = os.path.join(HERE, "golden", "golden.fa")


def _dir_bytes(d: str) -> dict[str, bytes]:
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def _argv(fa, out, prefix="t_", k=K, m=M, b=B, use_ht="0", part=("0",), read_len=64):
    return [str(k), str(m), "3", str(b), use_ht, "0", fa, out, prefix, "1", "0", *part,
            "--reads-per-batch", "4", "--read-len", str(read_len)]


def test_cli_cpu_reproduces_golden(tmp_path):
    out = str(tmp_path) + "/"
    assert tcli.main(_argv(GOLDEN_FA, out, "gold_") + ["--device", "cpu"]) == 0
    got = _dir_bytes(os.path.join(out, f"gold_k{K}_m{M}_x3_b{B}_s0"))
    got = {n: b for n, b in got.items() if n.startswith("bin")}
    assert got == _dir_bytes(os.path.join(HERE, "golden", "expected"))


def test_cli_matches_jax_cli(tmp_path):
    """Same positionals (custom partitioner recorded as at --mesh 1), same
    --prededup/--unique-ub: byte-identical directory, manifest included."""
    fa = str(tmp_path / "in.fa")
    write_fasta(fa, mixed_reads(11, n=40))
    out = str(tmp_path) + "/"
    argv = _argv(fa, out, "cp_", k=25, m=8, b=32, part=("1", "4"), read_len=256)
    argv += ["--prededup", "on", "--unique-ub", "100000"]
    d = os.path.join(out, "cp_k25_m8_x3_b32_s0")
    stats = str(tmp_path / "stats.json")
    assert jcli.main(argv + ["--platform", "cpu"]) == 0
    want = _dir_bytes(d)
    assert tcli.main(argv + ["--device", "cpu", "--stats-json", stats]) == 0
    assert _dir_bytes(d) == want
    summary = json.load(open(stats))
    assert summary["sync_free_feed"] is True and summary["prededup"] == "on"
    man = json.loads(want["manifest.json"])
    assert man["config"]["use_custom_partitioner"] is True
    assert man["config"]["num_partition_tasks"] == 4


@pytest.mark.parametrize("extra,use_ht", [
    (["--mesh", "4", "--checkpoint-dir", "ck"], "0"),
    (["--multiseq"], "0"),
    (["--smer-transport"], "0"),
    (["--checkpoint-dir", "ck"], "0"),
    (["--checkpoint-interval", "2"], "0"),
    (["--keep-table"], "0"),
    (["--trace-dir", "tr"], "0"),
    (["--distance-measure", "multisequence.KLDLog2"], "0"),
    ([], "1"),
])
def test_unported_flags_raise(tmp_path, extra, use_ht):
    """A flag without effect on the selected path raises, as in the JAX
    CLI: --smer-transport alone has no exchange to shape, and
    --distance-measure applies to --multiseq runs only.  Every flag that
    was ported (useHT=1, the checkpoint flags, --keep-table, --trace-dir,
    --multiseq) runs and leaves its artifact: a verified directory, an
    emptied checkpoint directory, table.npz, the trace, no EOF line,
    distances.json."""
    out = tmp_path / "out"
    extra = [str(tmp_path / a) if a in ("ck", "tr") else a for a in extra]
    argv = _argv(GOLDEN_FA, str(out) + "/", use_ht=use_ht) + ["--device", "cpu"]
    if extra[:1] in (["--smer-transport"], ["--distance-measure"]):
        match = ("use --mesh N" if extra == ["--smer-transport"]
                 else "applies to --multiseq runs only")
        with pytest.raises(NotImplementedError, match=match):
            tcli.main(argv + extra)
        assert not os.listdir(tmp_path)  # raised before any output
        return
    assert tcli.main(argv + extra) == 0
    d = str(out / f"t_k{K}_m{M}_x3_b{B}_s0")
    assert tapi.verify_output(d)["ok"]
    assert os.path.exists(os.path.join(d, "distances.json")) == ("--multiseq" in extra)
    if "--checkpoint-dir" in extra:
        assert os.path.isdir(tmp_path / "ck") and not os.listdir(tmp_path / "ck")
    if "--keep-table" in extra:
        assert os.path.exists(os.path.join(d, "table.npz"))
    if "--trace-dir" in extra:
        assert os.listdir(tmp_path / "tr")
    bins = [n for n in os.listdir(d) if n.startswith("bin")]
    assert bins and all(open(os.path.join(d, n), "rb").read().endswith(b"EOF")
                        == (use_ht == "0") for n in bins)


def test_device_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = _argv(GOLDEN_FA, str(tmp_path) + "/")  # --device defaults to cuda
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(argv + ["--device", "cuda"])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("mesh", [1, 4])
def test_multiseq_cli_matches_jax_cli(tmp_path, mesh):
    """--multiseq under a non-default measure, on one device and on
    --mesh 4 with LPT placement: the JAX CLI's directory byte for byte
    (bins, distances.json, manifest) and its summary's multiseq keys."""
    from .test_torch_multiseq import write_multiseq_fasta

    fa = str(tmp_path / "in.fa")
    write_multiseq_fasta(fa, 11, n_seq=3, n_reads=12)
    out = str(tmp_path) + "/"
    argv = _argv(fa, out, "ms_", k=28, m=8, b=32, part=("1", "4"), read_len=256)
    argv += ["--multiseq", "--distance-measure", "kld_log2", "--mesh", str(mesh)]
    stats = str(tmp_path / "stats.json")
    assert jcli.main(argv + ["--platform", "cpu", "--stats-json", stats]) == 0
    d = os.path.join(out, "ms_k28_m8_x3_b32_s0")
    want, jsum = _dir_bytes(d), json.load(open(stats))
    assert tcli.main(argv + ["--device", "cpu", "--stats-json", stats]) == 0
    assert _dir_bytes(d) == want and "distances.json" in want
    tsum = json.load(open(stats))
    assert tsum["mode"] == "multiseq" and tsum["device"] == "cpu" and tsum["n_batches"] > 1
    for key, value in jsum.items():
        if key != "timings":
            assert tsum[key] == value, key
    assert set(tsum["timings"]) == set(jsum["timings"])
    assert ("exchange_bytes" in tsum) == (mesh > 1) != ("sync_free_feed" in tsum)


@pytest.mark.parametrize("extra,match", [
    (["--multiseq", "--mesh", "4", "--smer-transport"], "no smer record format"),
    (["--distance-measure", "kld_logn", "--mesh", "4"], "applies to --multiseq runs only"),
    (["--multiseq", "--prededup", "on"], "single-chip --multiseq has no dedup step"),
])
def test_multiseq_flag_errors(tmp_path, extra, match):
    """The JAX CLI's three multiseq errors, raised before any output, by
    both CLIs; the default measure without --multiseq is accepted."""
    argv = _argv(GOLDEN_FA, str(tmp_path / "out") + "/") + extra
    with pytest.raises(NotImplementedError, match=match):
        jcli.main(argv + ["--platform", "cpu"])
    with pytest.raises(NotImplementedError, match=match):
        tcli.main(argv + ["--device", "cpu"])
    assert not os.listdir(tmp_path)
    assert tcli.build_parser().parse_args(argv).distance_measure == (
        extra[extra.index("--distance-measure") + 1] if "--distance-measure" in extra
        else "multisequence.SquaredEuclidean")
