"""Build the port's host C++ sources with g++ at first use.

The port's copy of ``fastkmer_tpu.utils.nativebuild``, with another build
location: a library lands in ``build/fastkmer_tpu_torch/`` beside the
package (git-ignored), named by a content hash of its source and flags, so
a binary built from other sources is never loaded.  The library is built
with ``-march=native``: keep the build directory out of copies to other
machines.  A failed build returns None and the caller takes its numpy path.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "fastkmer_tpu_torch")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def build(name: str, src: str, extra_flags: tuple = ()) -> str | None:
    """Compile ``src`` into lib<name>-<hash>.so unless a library built from
    exactly this source and these flags exists.  Returns its path, or None
    when g++ is missing or fails."""
    flags = GXX_FLAGS + tuple(extra_flags)
    h = hashlib.sha256(" ".join(flags).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    so = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, src, *extra_flags],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        return None
    return so
