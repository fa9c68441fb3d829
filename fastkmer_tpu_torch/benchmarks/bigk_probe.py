"""Extract plus count at k up to 201: the plain extract against kernel A.

The port of ``benchmarks/bigk_probe.py``.  On R x L random codes (drawn
from ``default_rng(0)`` as the JAX probe draws them), for each (k, m) of
``KMS`` with B = 512, two arms of one count step, each timed after a
warm-up (CUDA events on the card):

* ``plain``: ``extract.extract``, every word lane set to the all-ones
  sentinel where the window is invalid, then
  ``count_sort.count_presentineled``;
* ``kernel``: kernel A (``cuda_extract.extract_sentinel``), then the same
  count.

The two arms' counts must be equal at every k, and neither arm is guarded:
kernel A's staged route holds every k of the list, so a failure raises.
Each arm's line carries ``kernel_launches``, the launches of kernel A made
while that arm ran (0 for ``plain``).  The kernel arm's line also holds W,
``cuda_extract.count_route(k)``, kernel A's own time and its bound: R·L
bytes in and W·4·R·(L - k + 1) bytes out at ``HBM_BYTES_PER_S``.  The JAX
probe's other question, whether the TPU compiler takes W = 5 and 7, has no
counterpart here.

    python -m fastkmer_tpu_torch.benchmarks.bigk_probe [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.bits import num_words
from ..ops import count_sort, cuda_extract, extract
from ..pipeline import resolve_device
from ._common import HBM_BYTES_PER_S, device_ms, device_name, emit

R, L, B = 1024, 4096, 512
ITERS = 5
KMS = ((28, 10), (75, 12), (97, 13), (155, 10), (201, 14))


def plain_step(codes: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """The JAX probe's ``jnp_step``: plain extract, sentinel, count."""
    ex = extract.extract(codes, k, m, B)
    cols = [torch.where(ex.valid, ex.words[:, w], -1) for w in range(ex.words.shape[1])]
    return count_sort.count_presentineled(cols).counts


def kernel_step(codes: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """The JAX probe's ``pallas_step``: kernel A, then the same count."""
    return count_sort.count_presentineled(list(cuda_extract.extract_sentinel(codes, k, m, B))
                                          ).counts


def run(R: int = R, L: int = L, kms=KMS, device="cuda") -> list:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 4, size=(R, L), dtype=np.uint8)).to(dev)
    lines = []
    for k, m in kms:
        W, P = num_words(k), L - k + 1
        counts, ms, launches = {}, {}, {}
        for arm, step in (("plain", plain_step), ("kernel", kernel_step)):
            before = cuda_extract.LAUNCHES
            counts[arm] = step(codes, k, m)
            ms[arm] = device_ms(lambda: step(codes, k, m), ITERS, dev)
            if arm == "kernel":
                kernel_ms = device_ms(lambda: cuda_extract.extract_sentinel(codes, k, m, B),
                                      ITERS, dev)
            launches[arm] = cuda_extract.LAUNCHES - before
        if not torch.equal(counts["plain"], counts["kernel"]):
            raise RuntimeError(f"bigk_probe: k={k}: kernel A's counts differ from the plain "
                               "extract's")
        n_unique = int((counts["plain"] > 0).sum())
        for arm in ("plain", "kernel"):
            line = {"probe": "bigk", "k": k, "m": m, "arm": arm, "ms": ms[arm],
                    "gbps": R * L / ms[arm] / 1e6, "kernel_launches": launches[arm],
                    "n_unique": n_unique}
            if arm == "kernel":
                bound_ms = (R * L + W * 4 * R * P) / HBM_BYTES_PER_S * 1e3
                line.update(W=W, route=cuda_extract.count_route(k), kernel_ms=kernel_ms,
                            bound_ms=bound_ms, bound_share=bound_ms / kernel_ms)
            line["device"] = device_name(dev)
            lines.append(emit(**line))
    return lines


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    run(device=a.device)


if __name__ == "__main__":
    main()
