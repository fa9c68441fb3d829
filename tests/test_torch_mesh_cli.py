"""``python -m fastkmer_tpu_torch.cli --mesh 4 --smer-transport --device
cpu`` vs ``python -m fastkmer_tpu.cli --mesh 4 --smer-transport --platform
cpu`` (4 of the 8 virtual CPU devices): byte-identical output directories
with LPT placement for text output, and identical npz members for
enableKryo=1 (the zip timestamps differ between any two runs)."""

import io
import json
import os
import shutil
import zipfile

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from fastkmer_tpu import cli as jcli  # noqa: E402
from fastkmer_tpu_torch import cli as tcli  # noqa: E402

from .test_pipeline_e2e import write_fasta  # noqa: E402
from .test_torch_cli import _dir_bytes  # noqa: E402
from .test_torch_pipeline import mixed_reads  # noqa: E402


def _npz_members(path: str) -> dict[str, np.ndarray]:
    z = zipfile.ZipFile(path)
    return {n: np.load(io.BytesIO(z.read(n))) for n in sorted(z.namelist())}


@pytest.mark.parametrize("kryo,part", [("0", ("1", "4")), ("1", ("0",))])
def test_mesh_cli_matches_jax_cli(tmp_path, kryo, part):
    fa = str(tmp_path / "in.fa")
    write_fasta(fa, mixed_reads(17, n=40))
    out = str(tmp_path) + "/"
    argv = ["28", "10", "3", "64", "0", "0", fa, out, "m_", "1", kryo, *part,
            "--mesh", "4", "--smer-transport", "--reads-per-batch", "8", "--read-len", "256"]
    d = os.path.join(out, "m_k28_m10_x3_b64_s0")
    assert jcli.main(argv + ["--platform", "cpu"]) == 0
    want = _dir_bytes(d)
    shutil.rmtree(d)
    stats = str(tmp_path / "stats.json")
    assert tcli.main(argv + ["--device", "cpu", "--stats-json", stats]) == 0
    got = _dir_bytes(d)
    summary = json.load(open(stats))
    assert summary["placement"] == ["cpu"] * 4 and summary["mesh"] == 4
    assert summary["exchange_bytes"] > 0 and summary["n_dedup_batches"] == 0
    assert summary["sync_free_feed"] is False and summary["prededup"] == "auto"
    if part[0] == "1":
        assert summary["balance"]["total"] > 0
    if kryo == "0":
        assert got == want
        return
    assert sorted(got) == sorted(want) == ["counts.npz", "manifest.json"]
    jpath = str(tmp_path / "jax_counts.npz")
    with open(jpath, "wb") as f:
        f.write(want["counts.npz"])
    tm, jm = _npz_members(os.path.join(d, "counts.npz")), _npz_members(jpath)
    assert sorted(tm) == sorted(jm)
    for name in tm:
        np.testing.assert_array_equal(tm[name], jm[name])
    tman, jman = json.loads(got["manifest.json"]), json.loads(want["manifest.json"])
    assert tman["config"] == jman["config"]
