"""EXR I/O through the exr_lite C++ library (ctypes).

The counterpart of the JAX package's `utils/exr.py`: self-contained
scanline OpenEXR support (NONE/RLE/ZIPS/ZIP/PIZ read, NONE/ZIP write),
with no download (the reference relies on imageio fetching the freeimage
plugin, reference: test/utils.py:4-6). The library is this package's copy
of the source, `csrc/exr_lite.cpp`, built with g++ at first use into
`build/host/` (utils/cuda_build.load_host_library).
"""

from __future__ import annotations

import ctypes

import numpy as np

from diffusionhandles_tpu_torch.utils.cuda_build import load_host_library

_INT_P = ctypes.POINTER(ctypes.c_int)
_FLOAT_P = ctypes.POINTER(ctypes.c_float)


def _load() -> ctypes.CDLL:
    lib = load_host_library("exr_lite", "exr_lite.cpp", ("-lz",))
    lib.exr_info_names.argtypes = [ctypes.c_char_p, _INT_P, _INT_P, _INT_P,
                                   ctypes.c_char_p, ctypes.c_int]
    lib.exr_info_names.restype = ctypes.c_int
    lib.exr_read.argtypes = [ctypes.c_char_p, _FLOAT_P]
    lib.exr_read.restype = ctypes.c_int
    lib.exr_write.argtypes = [ctypes.c_char_p, _FLOAT_P, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                              ctypes.c_int, ctypes.c_int]
    lib.exr_write.restype = ctypes.c_int
    lib.exr_last_error.argtypes = []
    lib.exr_last_error.restype = ctypes.c_char_p
    return lib


def _err(lib) -> str:
    return lib.exr_last_error().decode("utf-8", "replace")


def read_exr(path: str, channel_order=None) -> np.ndarray:
    """Read an EXR -> float32 [H, W] (single channel) or [H, W, C].

    Channels come back in file (alphabetical) order unless `channel_order`
    names a permutation (e.g. ["R", "G", "B"])."""
    lib = _load()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    names_buf = ctypes.create_string_buffer(4096)
    if lib.exr_info_names(str(path).encode(), ctypes.byref(w),
                          ctypes.byref(h), ctypes.byref(c), names_buf,
                          len(names_buf)) != 0:
        raise IOError(f"exr_info({path}): {_err(lib)}")
    out = np.empty((h.value, w.value, c.value), np.float32)
    if lib.exr_read(str(path).encode(), out.ctypes.data_as(_FLOAT_P)) != 0:
        raise IOError(f"exr_read({path}): {_err(lib)}")
    if channel_order is not None:
        names = names_buf.value.decode().split(";")
        out = out[..., [names.index(n) for n in channel_order]]
    return out[..., 0] if out.shape[-1] == 1 else out


def write_exr(path: str, data: np.ndarray, channel_names=None,
              half: bool = True, compression: str = "zip") -> None:
    """Write float32 [H, W] or [H, W, C] data as a scanline EXR (half or
    float channels; 'zip' or 'none' compression)."""
    data = np.ascontiguousarray(np.asarray(data, np.float32))
    if data.ndim == 2:
        data = data[..., None]
    h, w, c = data.shape
    if channel_names is None:
        channel_names = (["Y"] if c == 1 else
                         ["R", "G", "B", "A"][:c] if c <= 4 else
                         [f"C{i}" for i in range(c)])
    names = ";".join(channel_names).encode()
    comp = {"none": 0, "zip": 3}[compression]
    lib = _load()
    if lib.exr_write(str(path).encode(), data.ctypes.data_as(_FLOAT_P),
                     w, h, c, names, 1 if half else 2, comp) != 0:
        raise IOError(f"exr_write({path}): {_err(lib)}")
