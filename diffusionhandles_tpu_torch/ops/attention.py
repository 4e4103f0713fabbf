"""Attention for the diffusion stack: dense attention, the two hand-written
flash-attention kernels and the gate that picks between them.

Layouts follow the JAX package's `ops/attention.py`:
q, k, v are [B, S, H, D]; the kernels work on head-major [B*H, S, D] copies
and the row log-sum-exp is [B*H, S] fp32.

The kernels are CUDA C++ for Hopper (`csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`),
built at first use (`utils/cuda_build.py`). Beside each kernel is its plain
PyTorch version with the same precision recipe (`flash_fwd_ref`,
`flash_bwd_ref`). A wrapper runs the plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from diffusionhandles_tpu_torch.utils.cuda_build import (check_cuda_bf16,
                                                         load_library,
                                                         raise_on, stream_of)

# Launches of each kernel wrapper since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd": 0}

KERNEL_SOURCES = ("flash_fwd.cu", "flash_bwd.cu")
HEAD_DIM = 64  # the kernels' compiled head dim (flash_common.cuh: D)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Routing gate: the JAX package's _flash_ok (attention.py:156-263), so that
# the same layers take the kernels in both packages.
# ---------------------------------------------------------------------------

_S_STATE_BYTES = 10
_S_BLOCK_BUDGET = 80 * 1024 * 1024
_KV_RESIDENT_BUDGET = 16 * 1024 * 1024


def _fwd_blocks(sq: int, sk: int, block_q: int = 2048,
                block_k: int = 1 << 20) -> Tuple[int, int]:
    bq = min(block_q, sq)
    bk = min(block_k, sk)
    if bk == sk:
        while bq > 256 and bq * sk * _S_STATE_BYTES > _S_BLOCK_BUDGET:
            bq //= 2
        if bq * sk * _S_STATE_BYTES > _S_BLOCK_BUDGET:
            bk = min(2048, sk)
    return bq, bk


def _flash_supported(sq: int, sk: int, head_dim: int = 64) -> bool:
    bq, bk = _fwd_blocks(sq, sk)
    kv_resident = sk * head_dim * 2 <= _KV_RESIDENT_BUDGET
    return (kv_resident and sk % bk == 0 and sq % bq == 0
            and sq % min(1024, sq) == 0 and sk % min(1024, sk) == 0)


def flash_ok(sq: int, sk: int, head_dim: int = 64) -> bool:
    """True where the JAX package routes attention to its flash kernels:
    at least 512 keys, and shapes its kernels tile."""
    return sk >= 512 and _flash_supported(sq, sk, head_dim)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the card's reference)
# ---------------------------------------------------------------------------

def _heads_first(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _heads_last(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3)


def _prescale(q: torch.Tensor) -> torch.Tensor:
    """q * 1/sqrt(d) in fp32, rounded back to q's dtype (as the JAX
    wrappers pre-scale q)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return (q.float() * scale).to(q.dtype)


def flash_fwd_ref(q, k, v):
    """Plain version of the forward kernel: (o [B,S,H,D], lse [B*H,S]).

    fp32 logits of the input-dtype operands, one global row max, p rounded
    to v's dtype once and used for both the row sum and the value product
    (the JAX kernel's ones-column fold, attention.py:115-133)."""
    b, _, h, _ = q.shape
    qt = _heads_first(_prescale(q)).float()
    kt = _heads_first(k).float()
    vt = _heads_first(v).float()
    s = qt @ kt.transpose(1, 2)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).to(v.dtype).float()
    l = p.sum(dim=-1, keepdim=True)
    o = (p @ vt) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return _heads_last(o.to(q.dtype), b, h), lse


def flash_bwd_ref(q, k, v, o, lse, do):
    """Plain version of the backward kernels: (dq, dk, dv) [B,S,H,D].

    The JAX fused backward's recipe (attention.py:333-372, 484-546):
    p = exp(s - lse) in fp32, dv = bf16(p)^T dO, dp = dO V^T,
    ds = bf16(p * (dp - delta)), dk = ds^T q_scaled, dq = ds k * 1/sqrt(d)."""
    b, _, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qt = _heads_first(_prescale(q)).float()
    kt = _heads_first(k).float()
    vt = _heads_first(v).float()
    dot = _heads_first(do).float()
    delta = (dot * _heads_first(o).float()).sum(-1, keepdim=True)
    p = torch.exp(qt @ kt.transpose(1, 2) - lse.unsqueeze(-1))
    dv = p.to(do.dtype).float().transpose(1, 2) @ dot
    dp = dot @ vt.transpose(1, 2)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dk = ds.transpose(1, 2) @ qt
    dq = (ds @ kt) * scale
    return (_heads_last(dq.to(q.dtype), b, h),
            _heads_last(dk.to(k.dtype), b, h),
            _heads_last(dv.to(v.dtype), b, h))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_LIB = None


def kernel_library() -> ctypes.CDLL:
    """Build (first call) and load the flash-attention kernels."""
    global _LIB
    if _LIB is None:
        lib = load_library("flash_attention", KERNEL_SOURCES)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd_bf16.argtypes = [ptr] * 5 + [i32, i32, ptr]
        lib.flash_fwd_bf16.restype = i32
        lib.flash_bwd_bf16.argtypes = ([ptr] * 9 + [i32, i32, ctypes.c_float,
                                                    ptr])
        lib.flash_bwd_bf16.restype = i32
        _LIB = lib
    return _LIB


def _check_cuda(*tensors: torch.Tensor) -> None:
    check_cuda_bf16("flash kernels", *tensors)
    b, s, h, d = tensors[0].shape
    if d != HEAD_DIM:
        raise ValueError(f"flash kernels are built for head dim {HEAD_DIM}, "
                         f"got {d}")
    for t in tensors[1:]:
        if tuple(t.shape) != (b, s, h, d):
            raise ValueError(f"flash kernels: shape {tuple(t.shape)} != "
                             f"{(b, s, h, d)} (self-attention only)")


def flash_fwd_cuda(q, k, v):
    """Forward kernel on the card: (o [B,S,H,D] bf16, lse [B*H,S] fp32)."""
    _check_cuda(q, k, v)
    b, s, h, d = q.shape
    lib = kernel_library()
    qt = _heads_first(_prescale(q)).contiguous()
    kt = _heads_first(k).contiguous()
    vt = _heads_first(v).contiguous()
    o = torch.empty_like(qt)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_bf16(qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), b * h, s,
                                 stream_of(q))
    raise_on(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return _heads_last(o, b, h), lse


def flash_bwd_cuda(q, k, v, o, lse, do):
    """Backward kernels on the card: (dq, dk, dv) [B,S,H,D] bf16."""
    _check_cuda(q, k, v, o, do)
    b, s, h, d = q.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b * h, s):
        raise ValueError(f"lse must be fp32 [{b * h}, {s}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    lib = kernel_library()
    qt = _heads_first(_prescale(q)).contiguous()
    kt = _heads_first(k).contiguous()
    vt = _heads_first(v).contiguous()
    dot = _heads_first(do).contiguous()
    delta = (dot.float() * _heads_first(o).float()).sum(-1).contiguous()
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(qt) for _ in range(3))
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_bf16(qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
                                 dot.data_ptr(), lse.data_ptr(),
                                 delta.data_ptr(), dq.data_ptr(),
                                 dk.data_ptr(), dv.data_ptr(), b * h, s,
                                 1.0 / math.sqrt(d), stream_of(q))
    raise_on(err, "flash_bwd")
    LAUNCHES["flash_bwd"] += 1
    return _heads_last(dq, b, h), _heads_last(dk, b, h), _heads_last(dv, b, h)


def flash_fwd(q, k, v):
    """The forward kernel for CUDA tensors; its plain version for CPU ones."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v)
    return flash_fwd_cuda(q, k, v)


def flash_bwd(q, k, v, o, lse, do):
    """The backward kernels for CUDA tensors; their plain version for CPU
    ones."""
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, o, lse, do)
    return flash_bwd_cuda(q, k, v, o, lse, do)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention over [B, S, H, D]: the forward saves O
    and the row log-sum-exp, the backward recomputes p from them (the JAX
    package's flash_attention_diff custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_bwd(q, k, v, o, lse, do.contiguous())


def flash_attention(q, k, v):
    return FlashAttention.apply(q, k, v)


def dot_product_attention(q, k, v, *, return_probs: bool = False,
                          use_flash: bool = False):
    """Multi-head attention over [B, S, H, D] (the JAX package's
    dot_product_attention): explicit fp32 logits and softmax, probabilities
    rounded to v's dtype for the value product. With `use_flash` and no
    probability capture, shapes that pass `flash_ok` take the kernels."""
    if (use_flash and not return_probs
            and flash_ok(q.shape[1], k.shape[1], head_dim=q.shape[-1])):
        return flash_attention(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float()).to(q.dtype)
    if return_probs:
        return out, probs
    return out
