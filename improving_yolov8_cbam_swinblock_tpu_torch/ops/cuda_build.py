"""Build the package's CUDA sources with nvcc and load them through ctypes.

Each library is compiled at first use, for sm_90a, into
`<package>/_build/<name>-<hash>/lib<name>.so`, keyed by a hash of its sources,
every header under csrc/ and the flags, so a checkout builds what it runs and
a changed source or header rebuilds.
The sources expose a plain C interface (no PyTorch headers), which keeps a
build to seconds. A failed build raises with nvcc's output; nothing falls
back to another implementation.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *ARCH_FLAGS)


def find_nvcc() -> str:
    """nvcc of the toolkit PyTorch finds ($CUDA_HOME, $CUDA_PATH, PATH, the default install)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str, sources: Sequence[str], extra_flags: Sequence[str] = ()) -> Path:
    """Where the build of `sources` with `extra_flags` lives: keyed by the
    flags, the sources and every header under csrc/ (any source may include
    any of them)."""
    digest = hashlib.sha256(" ".join((*NVCC_FLAGS, *extra_flags)).encode())
    headers = sorted(p.name for p in CSRC_DIR.iterdir() if p.suffix in (".cuh", ".h"))
    for src in (*sources, *headers):
        digest.update(src.encode() + b"\0" + (CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}" / f"lib{name}.so"


def build(name: str, sources: Sequence[str], extra_flags: Sequence[str] = ()) -> Path:
    """Compile `sources` (file names under csrc/) into a shared library, with
    `extra_flags` after the common ones; returns its path. Reuses an existing
    build of the same sources and flags."""
    out = library_path(name, sources, extra_flags)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp, *(str(CSRC_DIR / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out

