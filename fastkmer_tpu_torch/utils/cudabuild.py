"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Modelled on ``fastkmer_tpu.utils.nativebuild``: a library is keyed by a
content hash of its sources and compiler flags, so a binary built from
other sources is never loaded.  Each source file has a plain C entry point
(no PyTorch headers), which keeps a build at seconds.  The library lands in
``build/fastkmer_tpu_torch/`` beside the package (git-ignored).

Unlike ``nativebuild.ensure_built``, which returns False on failure, a
failed build raises with nvcc's stderr: a CUDA tensor must never fall back
to a plain path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

from .nativebuild import BUILD_DIR

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the toolkit's default
    install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(paths: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for p in list(paths) + [os.path.join(CSRC, f) for f in headers]:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build(name: str, sources: tuple[str, ...]) -> str:
    """Compile csrc/<sources> into lib<name>-<hash>.so unless a library
    built from exactly these sources exists.  Returns its path."""
    paths = [os.path.join(CSRC, s) for s in sources]
    so = os.path.join(BUILD_DIR, f"lib{name}-{_digest(paths)[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, *paths],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name} (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, so)
    return so


@functools.cache
def load(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Build (if needed) and load a library once per process."""
    return ctypes.CDLL(build(name, sources))
