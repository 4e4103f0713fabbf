"""Build the package's CUDA sources into shared libraries at first use.

Each library is compiled by `nvcc` for Hopper (`sm_90a`) from the sources
under `diffusionhandles_tpu_torch/csrc/` into `build/kernels/` at the root
of the checkout (listed in `.gitignore`), and loaded with `ctypes`: the
sources expose a plain C interface, so no PyTorch header is compiled. The
file name carries a hash of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Sequence

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str, sources: Sequence[str]) -> pathlib.Path:
    """Where the library built from `sources` (file names under csrc/,
    plus every header there) lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    files = sorted(set(sources) | {p.name for p in CSRC.glob("*.cuh")})
    for fname in files:
        digest.update(fname.encode())
        digest.update((CSRC / fname).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Return the loaded library for `sources`, building it if needed.

    The compiler's resource report (`-Xptxas -v`) is kept beside the
    library as `<library>.log`."""
    path = library_path(name, sources)
    with _LOCK:
        lib = _LOADED.get(str(path))
        if lib is not None:
            return lib
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   *[str(CSRC / s) for s in sources]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed building {name} ({proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            path.with_suffix(".so.log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, path)  # atomic: concurrent builders agree
        lib = ctypes.CDLL(str(path))
        _LOADED[str(path)] = lib
        return lib


def build_log(name: str, sources: Sequence[str]) -> str:
    """The compiler's resource report of a library built in this checkout
    ("" when it was built elsewhere)."""
    log = library_path(name, sources).with_suffix(".so.log")
    return log.read_text() if log.exists() else ""
