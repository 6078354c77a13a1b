"""Build-at-first-use for the port's native libraries.

Each library is compiled from a source file in the package into
``eitx_torch/_build/`` (listed in .gitignore). The output name carries a
hash of the source text and the compiler command, so an edited source or
a changed flag rebuilds, and an unchanged one is reused. The build writes
to a temporary name and renames it into place, so processes that build
the same library at once (parallel test workers) never load a half-written
file. What the compiler printed (``nvcc -Xptxas -v`` reports each kernel's
registers, shared memory and spills there) is kept beside the library as
``<library>.log``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def build_shared(src: str, stem: str, compiler: Sequence[str],
                 timeout: float = 600.0) -> str:
    """Compile ``src`` into a shared library and return its path.

    ``compiler`` is the command without ``-o`` and the source, e.g.
    ``["g++", "-O3", "-fPIC", "-shared", "-std=c++17"]``. Raises
    ``subprocess.CalledProcessError`` (with the compiler's output) or
    ``FileNotFoundError`` when the toolchain is missing.
    """
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(compiler).encode())
    so = os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        done = subprocess.run(
            [*compiler, "-o", tmp, src],
            check=True, capture_output=True, text=True, timeout=timeout,
        )
        with open(so + ".log", "w") as fh:
            fh.write(done.stdout + done.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so
