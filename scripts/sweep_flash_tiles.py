"""Every forward tile of the flash-attention kernels at the U-Net's attention
shapes, and the backward, on one NVIDIA GPU.

    python3 scripts/sweep_flash_tiles.py

For each shape of chip_smoke.py's FWD_SHAPES and its CROSS_SHAPE, each
(consumer warpgroups, keys a step) of ops/attention.py's FWD_TILES, forced
through the private `_fwd_launch`, is held to the plain versions of K1 and
K5 (chip_smoke.py's tolerances) and timed device-ahead (chip_smoke.py's
`_device_ms`; back to back with `_wall_ms`), beside SDPA and the tile
`plan_flash` picks; the backward
(K2) is held to its plain version and timed beside SDPA forward + backward.
Prints one JSON line per reading, then the card's name and power limit.
Exits non-zero when a tile disagrees or no GPU is present.
"""

from __future__ import annotations

import itertools
import json
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    import torch.nn.functional as F

    from diffusionhandles_tpu_torch.ops import attention as att
    from diffusionhandles_tpu_torch.utils.cuda_build import build_log

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    att.kernel_library()
    print(json.dumps({"ptxas": [ln.strip() for ln in build_log(
        "flash_attention", att.KERNEL_SOURCES).splitlines()
        if "registers" in ln or "spill" in ln]}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    ok = True
    shapes = ([(b, s, s, h, d) for b, s, h, d in cs.FWD_SHAPES]
              + [cs.CROSS_SHAPE])
    for b, sq, sk, h, d in shapes:
        q, k, v = cs._qkv(rand, b, sq, sk, h, d)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = cs._device_ms(lambda: F.scaled_dot_product_attention(qt, kt,
                                                                    vt))
        refs = {False: att.flash_fwd_ref(q, k, v),
                True: att.flash_fwd_unfolded_ref(q, k, v)}
        picked = att.plan_flash(b, h, sq, sk)
        for (nwg, bn), f32 in itertools.product(att.FWD_TILES,
                                                (False, True)):
            plan = att.fixed_flash_plan(b, h, sq, nwg, bn)
            o, lse = att._fwd_launch(q, k, v, f32, "flash_fwd", plan)
            o_ref, lse_ref = refs[f32]
            err_o, tol_o = cs._rel_err(o, o_ref, cs.FWD_O_RTOL)
            err_l = (lse - lse_ref).abs().max().item()
            tol_l = cs.FWD_F32_LSE_ATOL if f32 else cs.FWD_LSE_ATOL
            good = err_o <= tol_o and err_l <= tol_l
            ok &= good
            ms = cs._device_ms(lambda: att._fwd_launch(
                q, k, v, f32, "flash_fwd", plan))
            wall_ms = cs._wall_ms(lambda: att._fwd_launch(
                q, k, v, f32, "flash_fwd", plan))
            print(json.dumps({
                "fwd": [b, sq, sk, h, d], "tile": [nwg, bn],
                "f32_sum": f32, "grid": plan.grid,
                "note": plan.note,
                "picked": (nwg, bn) == picked.launch_args(),
                "ms": ms, "wall_ms": wall_ms, "sdpa_ms": sdpa,
                "err": [err_o, err_l],
                "tol": [tol_o, tol_l], "ok": good}), flush=True)
    for b, sq, sk, h, d in ([(b, s, s, h, d) for b, s, h, d in cs.BWD_SHAPES]
                            + [cs.CROSS_SHAPE]):
        q, k, v = cs._qkv(rand, b, sq, sk, h, d)
        do = rand(q.shape)
        o, lse = att.flash_fwd_ref(q, k, v)
        got = att.flash_bwd_cuda(q, k, v, o, lse, do)
        again = att.flash_bwd_cuda(q, k, v, o, lse, do)
        want = att.flash_bwd_ref(q, k, v, o, lse, do)
        errs = [cs._rel_err(g, w, cs.BWD_RTOL) for g, w in zip(got, want)]
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        good = same and all(e <= t for e, t in errs)
        ok &= good
        qg, kg, vg = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg)
            torch.autograd.grad(out, (qg, kg, vg), dot)

        print(json.dumps({
            "bwd": [b, sq, sk, h, d],
            "ms": cs._device_ms(lambda: att.flash_bwd_cuda(q, k, v, o, lse,
                                                           do)),
            "sdpa_fwd_bwd_ms": cs._device_ms(sdpa_fwd_bwd),
            "err_tol": errs, "bitwise_repeatable": same, "ok": good}),
            flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
