"""fastkmer_tpu_torch.debug vs fastkmer_tpu.debug on the dataset of
``test_driver_debug.py``: the same per-bin signature dict, the same
``bin_signatures<N>.txt`` bytes, the same partition-balance dump and
stats.  Integer outputs, so the tolerance is equality."""


import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from fastkmer_tpu import debug as jdebug  # noqa: E402
from fastkmer_tpu.config import JobConfig  # noqa: E402
from fastkmer_tpu.parallel import partitioner  # noqa: E402
from fastkmer_tpu_torch import debug as tdebug  # noqa: E402

from .test_torch_mesh_driver import _reads  # noqa: E402
from .test_pipeline_e2e import write_fasta  # noqa: E402
from .test_torch_cli import _dir_bytes  # noqa: E402


@pytest.fixture(scope="module")
def fa(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("debug") / "reads.fa")
    # every m-mer (m >= 5) of AATT repeats and of its reverse complement
    # holds an AA: no allowed m-mer, the <none> signature
    write_fasta(path, _reads() + ["AATT" * 20])
    return path


def _cfg(fa, out, k=28, m=10):
    return JobConfig(dataset=fa, output_directory=out, k=k, m=m, max_b=64,
                     reads_per_batch=16, read_len=512, write=False)


@pytest.mark.parametrize("k,m,smax", [(28, 10, 64), (32, 9, 48), (13, 4, 32)])
def test_find_bin_signatures_matches_jax(fa, k, m, smax):
    cfg = _cfg(fa, "", k, m)
    got = tdebug.find_bin_signatures(cfg, smax, device="cpu")
    assert got == jdebug.find_bin_signatures(cfg, smax)
    assert any("<none>" in h for h in got.values()) == (m >= 5)


def test_save_bin_signatures_matches_jax(tmp_path, fa):
    jcfg = _cfg(fa, str(tmp_path / "jax") + "/sig_")
    tcfg = _cfg(fa, str(tmp_path / "torch") + "/sig_")
    want = _dir_bytes(jdebug.save_bin_signatures(jcfg))
    got = _dir_bytes(tdebug.save_bin_signatures(tcfg, device="cpu"))
    assert got == want and all(n.startswith("bin_signatures") for n in got)


@pytest.mark.parametrize("n", [3, 4])
def test_evaluate_partition_balance_matches_jax(tmp_path, fa, n):
    cfg = _cfg(fa, "")
    owner = partitioner.lpt_owner_map(np.arange(64)[::-1].copy(), n) if n == 3 else \
        partitioner.hash_owner_map(cfg.b, n)
    want = jdebug.evaluate_partition_balance(cfg, owner, str(tmp_path / "j.txt"))
    got = tdebug.evaluate_partition_balance(cfg, owner, str(tmp_path / "t.txt"), device="cpu")
    assert got == want and got["total"] > 0
    assert open(tmp_path / "t.txt", "rb").read() == open(tmp_path / "j.txt", "rb").read()
