"""Attention for the diffusion stack: dense attention, the hand-written
flash-attention kernels and the gates that pick between them.

Layouts follow the JAX package's `ops/attention.py`:
q is [B, Sq, H, D], k and v [B, Sk, H, D]; the row log-sum-exp is
[B*H, Sq] fp32.

The JAX package has three forward kernels and three backward kernels for
one function, which differ only in where they round. Each has its plain
PyTorch version here, with the same precision recipe, and a route on the
card:

| JAX kernel | plain version | route on the card (launch count) |
| K1 `_flash_onepass_fold_kernel` | `flash_fwd_ref` | `flash_fwd` |
| K5 `_flash_onepass_kernel` | `flash_fwd_unfolded_ref` | `flash_fwd_unfolded` |
| K4 `_flash_kernel` | `flash_fwd_stream_ref` | `flash_fwd_stream` |
| K2 `_flash_bwd_fused_kernel` | `flash_bwd_ref` | `flash_bwd` |
| K3 `_flash_bwd_dq/dkv_kernel` | `flash_bwd_twopass_ref` | `flash_bwd_twopass` |
| K6 `_flash_bwd_fused_fold_kernel` | `flash_bwd_fold_ref` | `flash_bwd_fold` |

The kernels are CUDA C++ for Hopper (`csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`:
TMA + wgmma), built at first use (`utils/cuda_build.py`). They read q, k, v,
O and dO in the [B, S, H, D] layout where they lie and write O, dq, dk and
dv in it, with the 1/sqrt(d) scale applied inside: one ctypes call per
direction and no torch op around it. K1 and K4/K5 are instantiations of one
forward kernel (a row sum over the rounded or the fp32 p) whose query tile
and key step come from `plan_flash`; K2, K3 and K6 launch the same
backward kernels (K3 at head dim 64, where its extra rounding of dq is
exact; K6 with delta formed from its bf16 hi/lo pair). A call takes the route `flash_route`
names from its device, dtype and head dim: the plain version on the CPU; on
the card these kernels for bf16 or fp16 (an instance each) at head dim 64,
else the general kernels
(`csrc/flash_general.cu` forward, `csrc/flash_general_bwd.cu` backward:
fp32, fp16 or bf16, any head dim, each variant's rounding points, on the
tensor cores with fp32 products as 3xTF32), counted as `<route>_general`
(e.g. `flash_fwd_general`).
"""

from __future__ import annotations

import array
import ctypes
import dataclasses
import functools
import itertools
import math
import os
from typing import Dict, Optional, Tuple

import torch

from diffusionhandles_tpu_torch.utils.cuda_build import (ELEM_CODES,
                                                         HALF_SUFFIX,
                                                         check_cuda,
                                                         elem_code, general,
                                                         load_library,
                                                         raise_on, route,
                                                         run_route, stream_of)
from diffusionhandles_tpu_torch.utils.profiling import span

# Launches of each kernel wrapper, the Hopper kernels' and the general
# kernels' (`<name>_general`), since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {
    n: 0 for k in ("flash_fwd", "flash_fwd_unfolded", "flash_fwd_stream",
                   "flash_bwd", "flash_bwd_twopass", "flash_bwd_fold")
    for n in (k, general(k))}
# the span of each wrapper's launch, by its LAUNCHES key
_SPANS = {n: "kernel." + n for n in LAUNCHES}

KERNEL_SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "flash_general.cu",
                  "flash_general_bwd.cu")
HEAD_DIM = 64  # the kernels' compiled head dim (flash_common.cuh: D)
# Inputs the wrappers copied to a dense layout because TMA could not read
# them in place (a strided head dim, or a base or stride off 16 bytes).
LAYOUT_COPIES: Dict[str, int] = {"flash": 0}
# The JAX package's switch of the backward kernel, read when the backward
# runs: "twopass" (K3), "fold" (K6), anything else K2.
BWD_ENV = "DIFFHANDLES_FLASH_BWD"


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Routing gates: the JAX package's _fwd_blocks, _flash_fwd_supported,
# _flash_supported and _flash_ok (attention.py:156-263), so that the same
# calls take the kernels in both packages.
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


def _flash_fwd_supported(sq: int, sk: int, block_q: int = 2048,
                         block_k: int = 1 << 20, head_dim: int = 64) -> bool:
    bq, bk = _fwd_blocks(sq, sk, block_q, block_k)
    kv_resident = sk * head_dim * 2 <= _KV_RESIDENT_BUDGET
    return kv_resident and sk % bk == 0 and sq % bq == 0


def _flash_supported(sq: int, sk: int, block_q: int = 2048,
                     block_k: int = 1 << 20, head_dim: int = 64) -> bool:
    return (_flash_fwd_supported(sq, sk, block_q, block_k, head_dim)
            and sq % min(1024, sq) == 0 and sk % min(1024, sk) == 0)


def flash_ok(sq: int, sk: int, head_dim: int = 64) -> bool:
    """True where the JAX package routes attention to its flash kernels:
    at least 512 keys, and shapes its kernels tile."""
    return sk >= 512 and _flash_supported(sq, sk, head_dim=head_dim)


def flash_route(device, dtype, head_dim: int) -> str:
    """The route (`utils.cuda_build.route`) of a flash call with q, k,
    v in `dtype` on `device`: the Hopper kernels take bf16 or fp16 at head
    dim 64, the general kernels the rest."""
    return route(device, dtype in HALF_SUFFIX and head_dim == HEAD_DIM)


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


def _fwd_operands(q, k, v):
    """Head-major fp32 copies of the pre-scaled q, k and v."""
    return (_heads_first(_prescale(q)).float(), _heads_first(k).float(),
            _heads_first(v).float())


def _fwd_result(q, acc, m, l):
    """(o [B,Sq,H,D] in q's dtype, lse [B*H,Sq]) from the value sums, the
    row max and the row sum."""
    b, _, h, _ = q.shape
    lse = (m + torch.log(l)).squeeze(-1)
    return _heads_last((acc / l).to(q.dtype), b, h), lse


def flash_fwd_ref(q, k, v):
    """Plain version of K1: (o [B,Sq,H,D], lse [B*H,Sq]).

    fp32 logits of the input-dtype operands, one global row max, p rounded
    to v's dtype once and used for both the row sum and the value product
    (the JAX kernel's ones-column fold, attention.py:115-133)."""
    qt, kt, vt = _fwd_operands(q, k, v)
    s = qt @ kt.transpose(1, 2)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).to(v.dtype).float()
    return _fwd_result(q, p @ vt, m, p.sum(dim=-1, keepdim=True))


def flash_fwd_unfolded_ref(q, k, v):
    """Plain version of K5 (attention.py:136-153): one global row max, the
    row sum over the fp32 p, p rounded to v's dtype only for the value
    product."""
    qt, kt, vt = _fwd_operands(q, k, v)
    s = qt @ kt.transpose(1, 2)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return _fwd_result(q, p.to(v.dtype).float() @ vt, m,
                       p.sum(dim=-1, keepdim=True))


def flash_fwd_stream_ref(q, k, v, block_k: int):
    """Plain version of K4 (attention.py:80-112): K/V in block_k chunks,
    a running row max and denominator updated per chunk, the row sum over
    the fp32 p, p rounded to v's dtype only for the value product."""
    qt, kt, vt = _fwd_operands(q, k, v)
    bh, sq, d = qt.shape
    acc = qt.new_zeros((bh, sq, d))
    m = qt.new_full((bh, sq, 1), -math.inf)
    l = qt.new_zeros((bh, sq, 1))
    for k0 in range(0, kt.shape[1], block_k):
        kc, vc = kt[:, k0:k0 + block_k], vt[:, k0:k0 + block_k]
        s = qt @ kc.transpose(1, 2)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vc
        m = m_new
    return _fwd_result(q, acc, m, l)


def _delta(ot: torch.Tensor, dot: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in fp32 [B*H, Sq, 1] of head-major O and dO."""
    return (dot.float() * ot.float()).sum(-1, keepdim=True)


def _bwd_common(q, k, v, o, lse, do):
    """fp32 head-major (q_scaled, k, dO, p, dv, dp) and delta of the
    backward recipes: p = exp(s - lse), dv = bf16(p)^T dO, dp = dO V^T."""
    qt, kt, vt = _fwd_operands(q, k, v)
    dot = _heads_first(do).float()
    delta = _delta(_heads_first(o), dot)
    p = torch.exp(qt @ kt.transpose(1, 2) - lse.unsqueeze(-1))
    dv = p.to(do.dtype).float().transpose(1, 2) @ dot
    return qt, kt, p, dv, dot @ vt.transpose(1, 2), delta


def _bwd_result(q, k, v, dq, dk, dv):
    b, _, h, _ = q.shape
    return (_heads_last(dq.to(q.dtype), b, h),
            _heads_last(dk.to(k.dtype), b, h),
            _heads_last(dv.to(v.dtype), b, h))


def flash_bwd_ref(q, k, v, o, lse, do):
    """Plain version of K2: (dq, dk, dv) [B,S,H,D].

    The JAX fused backward's recipe (attention.py:333-372, 484-546):
    p = exp(s - lse) in fp32, dv = bf16(p)^T dO, dp = dO V^T,
    ds = bf16(p * (dp - delta)), dk = ds^T q_scaled, dq = ds k * 1/sqrt(d)
    summed in fp32 and rounded once."""
    qt, kt, p, dv, dp, delta = _bwd_common(q, k, v, o, lse, do)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = (ds @ kt) * (1.0 / math.sqrt(q.shape[-1]))
    return _bwd_result(q, k, v, dq, ds.transpose(1, 2) @ qt, dv)


def flash_bwd_twopass_ref(q, k, v, o, lse, do):
    """Plain version of K3 (attention.py:282-330, 549-625): as K2, but dq
    is rounded to q's dtype before the 1/sqrt(d) scale, scaled in fp32 and
    rounded again (a second rounding that is exact at d = 64)."""
    qt, kt, p, dv, dp, delta = _bwd_common(q, k, v, o, lse, do)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = (ds @ kt).to(q.dtype).float() * (1.0 / math.sqrt(q.shape[-1]))
    return _bwd_result(q, k, v, dq, ds.transpose(1, 2) @ qt, dv)


def _delta_hi_lo(delta: torch.Tensor, dtype):
    """The bf16 (dtype) hi/lo split of -delta (attention.py:438-439)."""
    d_hi = (-delta).to(dtype)
    d_lo = (-delta - d_hi.float()).to(dtype)
    return d_hi, d_lo


def flash_bwd_fold_ref(q, k, v, o, lse, do):
    """Plain version of K6 (attention.py:375-481): -delta enters the dp
    product as its hi/lo pair in dO's dtype, ds = bf16(p * (dO V^T + d_hi
    + d_lo)); dq summed in fp32 and rounded once."""
    qt, kt, p, dv, dp, delta = _bwd_common(q, k, v, o, lse, do)
    d_hi, d_lo = _delta_hi_lo(delta, do.dtype)
    ds = (p * (dp + d_hi.float() + d_lo.float())).to(q.dtype).float()
    dq = (ds @ kt) * (1.0 / math.sqrt(q.shape[-1]))
    return _bwd_result(q, k, v, dq, ds.transpose(1, 2) @ qt, dv)


# ---------------------------------------------------------------------------
# The planner: the forward's query tile and key step, from the shape alone
# ---------------------------------------------------------------------------

SMS = 132                      # streaming multiprocessors of an H100 SXM
# (consumer warpgroups, keys a step) of the forward kernels
# csrc/flash_fwd.cu builds: a CTA owns 64 query rows per warpgroup (one
# warpgroup: two CTAs share an SM). scripts/sweep_flash_tiles.py timed
# (1, 64), (2, 64) and (2, 128) at the U-Net's four attention shapes and
# CROSS_SHAPE of chip_smoke.py; (2, 128) was the fastest at every one
# (PERF.md, Findings), so it is the one tile built.
FWD_TILES = ((2, 128),)
# Rows the backward's padded lse/delta rows round up to (flash_bwd.cu: PAD)
BWD_PAD = 128


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """One forward launch: `warpgroups` consumer warpgroups (64 query rows
    each) a CTA, `block_n` keys a step, `grid` CTAs in `waves` waves over
    the card's SMs. `note` says where the grid leaves SMs idle."""

    warpgroups: int
    block_n: int
    grid: int
    waves: int
    note: str = ""

    def launch_args(self) -> Tuple[int, int]:
        return self.warpgroups, self.block_n


def fixed_flash_plan(b: int, h: int, sq: int, warpgroups: int,
                     block_n: int) -> FlashPlan:
    """The forward plan with the given tile (tests use it to reach every
    kernel instance)."""
    grid = math.ceil(sq / (64 * warpgroups)) * h * b
    per_wave = SMS * (2 if warpgroups == 1 else 1)
    waves = math.ceil(grid / per_wave)
    note = ""
    if grid % per_wave:
        note = (f"{grid} CTAs in {waves} wave(s) of {per_wave}: the last "
                f"fills {grid % per_wave}")
    return FlashPlan(warpgroups, block_n, grid, waves, note)


@functools.lru_cache(maxsize=None)
def plan_flash(b: int, h: int, sq: int, sk: int) -> FlashPlan:
    """The forward's tile at [B, Sq, H, 64] queries over Sk keys: of the
    built tiles, the one whose CTAs' waves times query rows a CTA is least
    (the time of its longest-running SM, keys alike for every tile), ties
    to the larger tile and key step."""
    del sk
    return min((fixed_flash_plan(b, h, sq, nwg, bn) for nwg, bn in FWD_TILES),
               key=lambda p: (p.waves * p.warpgroups, -p.warpgroups,
                              -p.block_n))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_LIB = None


def kernel_library() -> ctypes.CDLL:
    """Build (first call) and load the flash-attention kernels."""
    global _LIB
    if _LIB is None:
        lib = load_library("flash_attention", KERNEL_SOURCES)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for sfx in HALF_SUFFIX.values():
            fwd, bwd = (getattr(lib, f"flash_{d}_{sfx}")
                        for d in ("fwd", "bwd"))
            fwd.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
            bwd.argtypes = [ptr] * 11 + [i32] * 5 + [ptr]
            fwd.restype = bwd.restype = i32
        lib.flash_general_fwd.argtypes = ([i32] + [ptr] * 6 + [i32] * 6
                                          + [f32, ptr])
        lib.flash_general_bwd.argtypes = ([i32] + [ptr] * 11 + [i32] * 6
                                          + [f32, ptr])
        for fn in (lib.flash_general_fwd, lib.flash_general_bwd):
            fn.restype = i32
        _LIB = lib
    return _LIB


def _check_cuda(q, *rest: torch.Tensor) -> None:
    """q [B,Sq,H,64] and k, v (and o, dO) [B,Sk,H,64] (o, dO: Sq) on one
    CUDA device, all bf16 or all fp16."""
    check_cuda("flash kernels", q, *rest, dtypes=tuple(HALF_SUFFIX))
    b, _, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash kernels are built for head dim {HEAD_DIM}, "
                         f"got {d}")
    for t in rest:
        if t.dim() != 4 or (t.shape[0], t.shape[2], t.shape[3]) != (b, h, d):
            raise ValueError(f"flash kernels: shape {tuple(t.shape)} is not "
                             f"[{b}, S, {h}, {d}]")


def _tma_operand(x: torch.Tensor):
    """(x, (sb, ss, sh)): a [B, S, H, 64] operand as the kernels read it in
    place, with its strides in elements. TMA needs a unit-stride head dim
    and the base and other strides in 16-byte units; an input without them
    is copied dense once (counted in LAYOUT_COPIES). A size-1 dim's stride
    is never stepped, so it gets the dense value."""
    b, s, h, d = x.shape
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x, (s * h * d, h * d, d)
    sb, ss, sh, sd = x.stride()
    sh = sh if h > 1 else d
    ss = ss if s > 1 else h * sh
    sb = sb if b > 1 else s * ss
    if (sd != 1 or x.data_ptr() % 16
            or any(st <= 0 or st % 8 for st in (sb, ss, sh))):
        LAYOUT_COPIES["flash"] += 1
        return x.contiguous(), (s * h * d, h * d, d)
    return x, (sb, ss, sh)


def _strides_arg(strides) -> array.array:
    """The operands' strides as the int64 array the entries read; the
    caller keeps it alive across the call and passes its address."""
    return array.array("q", itertools.chain.from_iterable(strides))


def _fwd_launch(q, k, v, f32_sum: bool, name: str,
                plan: Optional[FlashPlan] = None):
    """Run the forward kernel with `plan` or the planner's (the CUDA tests
    force plans through here to reach every kernel instance): (o
    [B,Sq,H,D] in q's dtype, dense, lse [B*H,Sq] fp32)."""
    _check_cuda(q, k, v)
    if k.shape[1] != v.shape[1]:
        raise ValueError(f"flash kernels: k and v lengths differ "
                         f"({k.shape[1]} != {v.shape[1]})")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    plan = plan or plan_flash(b, h, sq, sk)
    with span(_SPANS[name]):
        lib = kernel_library()
        (q, sq_), (k, sk_), (v, sv_) = (_tma_operand(x) for x in (q, k, v))
        o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
        strides = _strides_arg((sq_, sk_, sv_))
        with torch.cuda.device(q.device):
            err = getattr(lib, f"flash_fwd_{HALF_SUFFIX[q.dtype]}")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), strides.buffer_info()[0], b, sq, sk, h,
                *plan.launch_args(), int(f32_sum), stream_of(q))
        raise_on(err, name)
        LAUNCHES[name] += 1
    return o, lse


def flash_fwd_cuda(q, k, v):
    """K1 on the card: (o [B,Sq,H,D] in q's dtype, bf16 or fp16, lse
    [B*H,Sq] fp32)."""
    return _fwd_launch(q, k, v, False, "flash_fwd")


def flash_fwd_unfolded_cuda(q, k, v):
    """K5 on the card: the forward kernel with the fp32 row sum."""
    return _fwd_launch(q, k, v, True, "flash_fwd_unfolded")


def flash_fwd_stream_cuda(q, k, v):
    """K4 on the card: the same fp32-row-sum kernel, which streams K/V in
    tiles of the plan's keys whatever K4's block_k (block_k only moves
    where the plain version rounds p)."""
    return _fwd_launch(q, k, v, True, "flash_fwd_stream")


def _bwd_cuda(q, k, v, o, lse, do, name: str, fold_delta: bool = False):
    """Launch the backward kernels (one call: the delta prologue, dk/dv and
    dq). delta = rowsum(dO * O) in fp32 or, with `fold_delta`,
    -(d_hi + d_lo) of K6's bf16 hi/lo pair."""
    _check_cuda(q, k, v, o, do)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if (tuple(do.shape) != tuple(q.shape) or tuple(o.shape) != tuple(q.shape)
            or tuple(v.shape) != tuple(k.shape)):
        raise ValueError(f"flash kernels: O {tuple(o.shape)} and dO "
                         f"{tuple(do.shape)} must be q's shape and v "
                         f"{tuple(v.shape)} k's")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b * h, sq):
        raise ValueError(f"lse must be fp32 [{b * h}, {sq}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    with span(_SPANS[name]):
        lib = kernel_library()
        operands = [_tma_operand(x) for x in (q, k, v, o, do)]
        (q, _), (k, _), (v, _), (o, _), (do, _) = operands
        lse = lse.contiguous()
        dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
        dv = torch.empty_like(dk)
        sqp = math.ceil(sq / BWD_PAD) * BWD_PAD
        scratch = torch.empty((2 * b * h * sqp,), dtype=torch.float32,
                              device=q.device)
        strides = _strides_arg([st for _, st in operands])
        with torch.cuda.device(q.device):
            err = getattr(lib, f"flash_bwd_{HALF_SUFFIX[q.dtype]}")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), scratch.data_ptr(), strides.buffer_info()[0],
                b, sq, sk, h, int(fold_delta), stream_of(q))
        raise_on(err, name)
        LAUNCHES[name] += 1
    return dq, dk, dv


def flash_bwd_cuda(q, k, v, o, lse, do):
    """K2 on the card: (dq, dk, dv) in q's dtype, bf16 or fp16."""
    return _bwd_cuda(q, k, v, o, lse, do, "flash_bwd")


def flash_bwd_twopass_cuda(q, k, v, o, lse, do):
    """K3 on the card: the backward kernels, which round dq once after the
    scale; built for d = 64 only, where K3's rounding before the scale
    (by 1/8, exact in bf16) gives the same dq."""
    return _bwd_cuda(q, k, v, o, lse, do, "flash_bwd_twopass")


def flash_bwd_fold_cuda(q, k, v, o, lse, do):
    """K6 on the card: the backward kernels fed delta = -(d_hi + d_lo), the
    fp32 sum of the bf16 hi/lo pair that K6 adds inside its dp product."""
    return _bwd_cuda(q, k, v, o, lse, do, "flash_bwd_fold", fold_delta=True)


def _check_general(q, k, v, *rest) -> None:
    """q [B,Sq,H,D], k, v [B,Sk,H,D] (O, dO: q's shape) on one CUDA device
    in one dtype the general kernels take."""
    check_cuda("flash general kernels", q, k, v, *rest,
               dtypes=tuple(ELEM_CODES))
    b, _, h, d = q.shape
    if (k.dim() != 4 or tuple(v.shape) != tuple(k.shape)
            or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d)
            or any(tuple(t.shape) != tuple(q.shape) for t in rest)):
        raise ValueError(f"flash general kernels: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"[{b}, S, {h}, {d}]")


def _fwd_general(q, k, v, f32_sum: bool, name: str):
    """The general forward kernel (K1, or K4/K5 with `f32_sum`): (o
    [B,Sq,H,D] in q's dtype, dense, lse [B*H,Sq] fp32). q, k and v are
    read in place through their strides."""
    _check_general(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    with span(_SPANS[general(name)]):
        o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
        strides = _strides_arg(x.stride() for x in (q, k, v))
        with torch.cuda.device(q.device):
            err = kernel_library().flash_general_fwd(
                elem_code(q.dtype), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                strides.buffer_info()[0], b, sq, sk, h, d, int(f32_sum),
                1.0 / math.sqrt(d), stream_of(q))
        raise_on(err, general(name))
        LAUNCHES[general(name)] += 1
    return o, lse


def _bwd_general(q, k, v, o, lse, do, name: str, mode: int):
    """The general backward kernels: (dq, dk, dv) in q's dtype, dense.
    mode 0: K2, 1: K3 (dq rounded before the scale), 2: K6 (delta from
    its hi/lo pair)."""
    _check_general(q, k, v, o, do)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b * h, sq):
        raise ValueError(f"lse must be fp32 [{b * h}, {sq}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    with span(_SPANS[general(name)]):
        lse = lse.contiguous()
        dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        dk = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
        dv = torch.empty_like(dk)
        delta = torch.empty((b * h * sq,), dtype=torch.float32,
                            device=q.device)
        strides = _strides_arg(x.stride() for x in (q, k, v, o, do))
        with torch.cuda.device(q.device):
            err = kernel_library().flash_general_bwd(
                elem_code(q.dtype), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                delta.data_ptr(), strides.buffer_info()[0], b, sq, sk, h, d,
                mode, 1.0 / math.sqrt(d), stream_of(q))
        raise_on(err, general(name))
        LAUNCHES[general(name)] += 1
    return dq, dk, dv


def flash_fwd_general(q, k, v):
    """K1's general kernel on the card (any dtype it takes, any head
    dim)."""
    return _fwd_general(q, k, v, False, "flash_fwd")


def flash_fwd_unfolded_general(q, k, v):
    """K5's general kernel: the fp32 row sum."""
    return _fwd_general(q, k, v, True, "flash_fwd_unfolded")


def flash_fwd_stream_general(q, k, v):
    """K4's general kernel: the fp32 row sum over its own key steps
    (block_k only moves where the plain version rounds p)."""
    return _fwd_general(q, k, v, True, "flash_fwd_stream")


def flash_bwd_general(q, k, v, o, lse, do):
    """K2's general kernels on the card."""
    return _bwd_general(q, k, v, o, lse, do, "flash_bwd", 0)


def flash_bwd_twopass_general(q, k, v, o, lse, do):
    """K3's general kernels: dq rounded before the scale as well."""
    return _bwd_general(q, k, v, o, lse, do, "flash_bwd_twopass", 1)


def flash_bwd_fold_general(q, k, v, o, lse, do):
    """K6's general kernels: delta = -(d_hi + d_lo) of its hi/lo pair."""
    return _bwd_general(q, k, v, o, lse, do, "flash_bwd_fold", 2)


def _routed(q, plain, kernel, general_kernel):
    """Call `plain`, `kernel` or `general_kernel` by flash_route of q."""
    return run_route(flash_route(q.device, q.dtype, q.shape[-1]), plain,
                     kernel, general_kernel)


def flash_fwd(q, k, v):
    """K1 by flash_route."""
    return _routed(q, lambda: flash_fwd_ref(q, k, v),
                   lambda: flash_fwd_cuda(q, k, v),
                   lambda: flash_fwd_general(q, k, v))


def flash_fwd_unfolded(q, k, v):
    """K5 by flash_route."""
    return _routed(q, lambda: flash_fwd_unfolded_ref(q, k, v),
                   lambda: flash_fwd_unfolded_cuda(q, k, v),
                   lambda: flash_fwd_unfolded_general(q, k, v))


def flash_fwd_stream(q, k, v, block_k: int):
    """K4 by flash_route."""
    return _routed(q, lambda: flash_fwd_stream_ref(q, k, v, block_k),
                   lambda: flash_fwd_stream_cuda(q, k, v),
                   lambda: flash_fwd_stream_general(q, k, v))


def flash_bwd(q, k, v, o, lse, do):
    """K2 by flash_route."""
    return _routed(q, lambda: flash_bwd_ref(q, k, v, o, lse, do),
                   lambda: flash_bwd_cuda(q, k, v, o, lse, do),
                   lambda: flash_bwd_general(q, k, v, o, lse, do))


def flash_bwd_twopass(q, k, v, o, lse, do):
    """K3 by flash_route."""
    return _routed(q, lambda: flash_bwd_twopass_ref(q, k, v, o, lse, do),
                   lambda: flash_bwd_twopass_cuda(q, k, v, o, lse, do),
                   lambda: flash_bwd_twopass_general(q, k, v, o, lse, do))


def flash_bwd_fold(q, k, v, o, lse, do):
    """K6 by flash_route."""
    return _routed(q, lambda: flash_bwd_fold_ref(q, k, v, o, lse, do),
                   lambda: flash_bwd_fold_cuda(q, k, v, o, lse, do),
                   lambda: flash_bwd_fold_general(q, k, v, o, lse, do))


# ---------------------------------------------------------------------------
# The JAX package's entry points
# ---------------------------------------------------------------------------

def flash_fwd_impl(q, k, v, block_q: int = 2048, block_k: int = 1 << 20,
                   fold: bool = True):
    """(o [B,Sq,H,D], lse [B*H,Sq]) by the route the JAX package's
    _flash_fwd_impl takes (attention.py:183-231): K1 when `fold` and the
    effective block_k spans all keys, K5 when it spans them without
    `fold`, else K4 over block_k chunks. The kernel on the card has no
    query block, so block_q only enters through _fwd_blocks."""
    _, bk = _fwd_blocks(q.shape[1], k.shape[1], block_q, block_k)
    if bk == k.shape[1]:
        return (flash_fwd if fold else flash_fwd_unfolded)(q, k, v)
    return flash_fwd_stream(q, k, v, bk)


def flash_attention(q, k, v, block_q: int = 2048, block_k: int = 1 << 20):
    """Forward-only flash attention over [B, S, H, D] (the JAX package's
    flash_attention, attention.py:266-279): the kernels where at least 512
    keys and the forward's block constraints hold, else dense attention.
    Its result carries no gradient on the card; flash_attention_diff is
    the differentiable entry."""
    if not (k.shape[1] >= 512
            and _flash_fwd_supported(q.shape[1], k.shape[1], block_q,
                                     block_k, head_dim=q.shape[-1])):
        return dot_product_attention(q, k, v)
    return flash_fwd_impl(q, k, v, block_q, block_k)[0]


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention over [B, S, H, D] (the JAX package's
    flash_attention_diff custom VJP, attention.py:631-663): the forward
    saves O and the row log-sum-exp, the backward recomputes p from them
    with the kernel that DIFFHANDLES_FLASH_BWD names when the backward
    runs: "twopass" K3, "fold" K6, anything else K2."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_fwd_impl(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mode = os.environ.get(BWD_ENV)
        bwd = {"twopass": flash_bwd_twopass,
               "fold": flash_bwd_fold}.get(mode, flash_bwd)
        return bwd(q, k, v, o, lse, do)


def flash_attention_diff(q, k, v):
    """Differentiable flash attention; the caller gates with flash_ok."""
    if not _flash_supported(q.shape[1], k.shape[1]):
        raise ValueError(
            f"flash_attention_diff: shapes sq={q.shape[1]} sk={k.shape[1]} "
            "are not block-aligned for the kernels; gate on flash_ok and "
            "fall back to dense attention")
    return FlashAttention.apply(q, k, v)


def dot_product_attention(q, k, v, *, return_probs: bool = False,
                          use_flash: bool = False):
    """Multi-head attention over q [B, Sq, H, D], k, v [B, Sk, H, D] (the
    JAX package's dot_product_attention): explicit fp32 logits and softmax,
    probabilities rounded to v's dtype for the value product. With
    `use_flash` and no probability capture, shapes that pass `flash_ok`
    take the kernels."""
    if (use_flash and not return_probs
            and flash_ok(q.shape[1], k.shape[1], head_dim=q.shape[-1])):
        return flash_attention_diff(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float()).to(q.dtype)
    if return_probs:
        return out, probs
    return out
