"""Build the port's CUDA sources into shared libraries at first use.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into `build/drone2d_tpu_torch/` at the root of the
checkout (listed in `.gitignore`).  The library's file name carries a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing here runs at import: the host that runs
the CPU tests has no `nvcc`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "drone2d_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to, keyed by its source and flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> dict:
    """Compile `csrc/<name>.cu` unless its library exists.

    Returns {"path", "seconds", "log"}: the library, the compile time (0.0
    when it was already built) and nvcc's output (register and shared-memory
    use per kernel, from -Xptxas -v).  Raises with nvcc's output on failure.
    """
    out = library_path(name)
    if out.exists():
        return {"path": out, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": proc.stdout + proc.stderr}
