"""The port's entry points (``fastkmer_tpu_torch.entry``) vs the
repository's ``__graft_entry__`` on the CPU: ``entry()``'s step output
(words, counts, bins, is_uniq, n_valid) bit-equal to the JAX step's on the
same codes, and ``dryrun_multichip(4, "cpu")``'s five numbers equal to
those the JAX dry run prints on 4 of the 8 virtual CPU devices.  Integer
outputs, so the tolerance is bit-equality; each JAX run is made once per
module."""

import json
import re

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as jentry  # noqa: E402
from fastkmer_tpu_torch import entry as tentry  # noqa: E402

DRYRUN_LINE = re.compile(
    r"dryrun_multichip\((\d+)\): ok, counted (\d+) k-mer instances \(one-shot\) \+ (\d+) "
    r"\(streaming, (\d+) uniques\) \+ dedup transport \((\d+) instances\) \+ multiseq lanes "
    r"\((\d+) \(kmer,seq\) pairs\)")
FIELDS = ("n_counted", "stream_total", "stream_unique", "dedup_total", "seq_pairs")


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the port's CPU runs here are many small ops, which
    several test workers' thread pools would otherwise fight over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_dryrun():
    """The JAX dry run's printed line, parsed (capsys is function-scoped,
    so the line is read from a redirected stdout)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jentry.dryrun_multichip(4)
    return buf.getvalue()


def test_entry_step_is_the_jax_step():
    jstep, (jcodes,) = jentry.entry()
    tstep, (tcodes,) = tentry.entry("cpu")
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    assert tcodes.shape == (64, 1024) and str(tcodes.device) == "cpu"
    want = [np.asarray(x) for x in jax.jit(jstep)(jcodes)]  # one compiled program
    got = [x.numpy() for x in tstep(tcodes)]
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    assert int(got[4]) == 64 * (1024 - 28 + 1)  # every window of random ACGT is valid


def test_dryrun_numbers_are_the_jax_ones(jax_dryrun, capsys):
    m = DRYRUN_LINE.search(jax_dryrun)
    assert m, jax_dryrun
    want = dict(zip(FIELDS, map(int, m.groups()[1:])))
    got = tentry.dryrun_multichip(4, "cpu")
    assert got == want
    line = capsys.readouterr().out.strip()
    assert DRYRUN_LINE.fullmatch(line) and line == jax_dryrun.strip()


def test_entry_cli(capsys):
    tentry.main(["--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["n_valid"] == 64 * 997 and out["rows"] == 64 * 997
    tentry.main(["--dryrun", "2", "--device", "cpu"])
    assert DRYRUN_LINE.fullmatch(capsys.readouterr().out.strip())
    if not torch.cuda.is_available():  # the default device is the card: no fallback
        with pytest.raises(RuntimeError, match="is_available"):
            tentry.entry()
        with pytest.raises(RuntimeError, match="is_available"):
            tentry.dryrun_multichip(2)
