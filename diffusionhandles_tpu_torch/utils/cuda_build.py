"""Build the package's CUDA sources into shared libraries at first use.

Each library is compiled by `nvcc` for Hopper (`sm_90a`), one process per
source, from the sources under `diffusionhandles_tpu_torch/csrc/` into
`build/kernels/` at the root of the checkout (listed in `.gitignore`), and
loaded with `ctypes`: the sources expose a plain C interface, so no PyTorch
header is compiled. The file name carries a hash of the sources and flags,
so an edited source is rebuilt and a stale library is never loaded. A
failed build raises. `load_host_library` builds a C++ source for the
host the same way, with g++, into `build/host/`. The launch and routing
helpers at the end are shared by the kernel wrappers of `ops/`.
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
from typing import Callable, Dict, Sequence, TypeVar

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB_LOCKS: Dict[str, threading.Lock] = {}
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
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    files = sorted(set(sources) | {p.name for p in CSRC.glob("*.cuh")})
    for fname in files:
        digest.update(fname.encode())
        digest.update((CSRC / fname).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _build(name: str, sources: Sequence[str], path: pathlib.Path) -> None:
    """One nvcc per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmpdir = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [tmpdir / f"{pathlib.Path(s).stem}.o" for s in sources]
        procs = [subprocess.Popen(
            [_nvcc(), *COMPILE_FLAGS, "-c", "-o", str(obj), str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, obj in zip(sources, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        tmp = tmpdir / "lib.so"
        ok = not any(proc.returncode for proc in procs)
        if ok:
            link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                                   *map(str, objs)],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            ok = link.returncode == 0
        if not ok:
            raise RuntimeError(f"nvcc failed building {name}:\n"
                               + "\n".join(logs))
        path.with_suffix(".so.log").write_text("\n".join(logs))
        os.replace(tmp, path)  # atomic: concurrent builders agree
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Return the loaded library for `sources`, building it if needed.

    Libraries build concurrently from different threads; the compiler's
    resource report (`-Xptxas -v`) is kept beside each library as
    `<library>.log`."""
    path = library_path(name, sources)
    with _LOCK:
        lock = _LIB_LOCKS.setdefault(str(path), threading.Lock())
    with lock:
        lib = _LOADED.get(str(path))
        if lib is None:
            if not path.exists():
                _build(name, sources, path)
            lib = ctypes.CDLL(str(path))
            _LOADED[str(path)] = lib
        return lib


HOST_BUILD_DIR = BUILD_DIR.parent / "host"
HOST_COMPILE_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")


def load_host_library(name: str, source: str,
                      link_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Return the loaded library built with g++ (or $CXX) from the C++
    `source` under csrc/, building it into build/host/ at first use (the
    file name carries a hash of the source and flags)."""
    cxx = os.environ.get("CXX", "g++")
    digest = hashlib.sha256(" ".join(
        (cxx, *HOST_COMPILE_FLAGS, *link_flags)).encode())
    digest.update((CSRC / source).read_bytes())
    path = HOST_BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    with _LOCK:
        lock = _LIB_LOCKS.setdefault(str(path), threading.Lock())
    with lock:
        lib = _LOADED.get(str(path))
        if lib is None:
            if not path.exists():
                HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=HOST_BUILD_DIR)
                os.close(fd)
                try:
                    proc = subprocess.run(
                        [cxx, *HOST_COMPILE_FLAGS, str(CSRC / source), "-o",
                         tmp, *link_flags], capture_output=True, text=True)
                    if proc.returncode:
                        raise RuntimeError(f"{cxx} failed building {name}:\n"
                                           + proc.stdout + proc.stderr)
                    os.replace(tmp, path)  # atomic: concurrent builds agree
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(str(path))
            _LOADED[str(path)] = lib
        return lib


def build_log(name: str, sources: Sequence[str]) -> str:
    """The compiler's resource report of a library built in this checkout
    ("" when it was built elsewhere)."""
    log = library_path(name, sources).with_suffix(".so.log")
    return log.read_text() if log.exists() else ""


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """The current CUDA stream of `t`'s device, as a launch argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(err: int, what: str) -> None:
    """Raise if a library entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def check_cuda(what: str, *tensors: torch.Tensor, aligned: bool = False,
               dtypes: Sequence[torch.dtype] = (torch.bfloat16,)) -> None:
    """Raise unless all `tensors` are on one CUDA device in one dtype, one
    of `dtypes` (bfloat16 by default) and, with `aligned`, contiguous and
    16-byte aligned (for vector loads)."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: all tensors must be on one CUDA "
                             f"device, got {[x.device for x in tensors]}")
        if t.dtype not in dtypes or t.dtype != tensors[0].dtype:
            raise TypeError(f"{what} takes "
                            f"{' or '.join(map(str, dtypes))}, got "
                            f"{[x.dtype for x in tensors]}")
        if aligned and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{what} takes contiguous, 16-byte aligned "
                             "tensors")


# The 16-bit types of the Hopper kernels' instances, and their entries'
# name suffixes (`<entry>_bf16`, `<entry>_f16`)
HALF_SUFFIX = {torch.bfloat16: "bf16", torch.float16: "f16"}
# The dtype codes of the kernels' element types (csrc/elem.cuh: ELEM_*)
ELEM_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def elem_code(dtype: torch.dtype) -> int:
    """The dtype code the general entries take for `dtype`."""
    if dtype not in ELEM_CODES:
        raise TypeError(f"the kernels take float32, float16 or bfloat16, "
                        f"got {dtype}")
    return ELEM_CODES[dtype]


def route(device, kernel_takes: bool) -> str:
    """The route of a call on `device`: "cpu" (the plain version, on the
    CPU); else "kernel" where `kernel_takes` (the call's dtype and shape
    are ones the op's Hopper kernel is built for), or "general" (the op's
    general kernel, for the other dtypes and shapes its gate admits). The
    kernel wrappers refuse tensors off a CUDA device."""
    if torch.device(device).type == "cpu":
        return "cpu"
    return "kernel" if kernel_takes else "general"


def general(name: str) -> str:
    """The launch counter of kernel `name`'s general route."""
    return f"{name}_general"


T = TypeVar("T")


def run_route(r: str, cpu: Callable[[], T], kernel: Callable[[], T],
              general_kernel: Callable[[], T]) -> T:
    """Call the function of route `r` (each wrapper counts its own
    launches)."""
    return {"cpu": cpu, "kernel": kernel, "general": general_kernel}[r]()
