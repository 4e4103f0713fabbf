"""Readings of the correctness check's two sides, to set its limits.

    python benchmark/control.py --workload <cell> --seeds 11,12,13 \
        [--seconds 0] [--out chiprun_out/control.jsonl]

For each seed, one run of the cell (its set-up and at least one request of
its traffic at the cell's own size) prints one JSON line with the check's
readings of the program ("program") and of the control ("control"): the
plain reference computed one precision below the configuration's, put in
the program's place and read through the same comparisons, from the same
program state. The configuration states bfloat16 for the U-Net and the VAE
and float32 for the geometry: the control runs the reference's U-Net and
VAE with weights and every matmul and convolution input rounded to fp8
(e4m3, one scale per tensor), and its depth transform in bfloat16. In
the edit cells it also reads two guidance faults planted in the float32
reference put in the program's place ("fault_negated", "fault_wrong_step":
see `_faults`). The benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch import nn  # noqa: E402



def fp8_(module: nn.Module) -> nn.Module:
    """Round `module`'s matmul and convolution weights to fp8 in place,
    and their inputs at every call."""
    from benchmark.reference.precision import round_weights_, to_fp8
    round_weights_(module, to_fp8)
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            mod.register_forward_pre_hook(
                lambda m, args: (to_fp8(args[0]),) + tuple(args[1:]))
    return module


def _faults():
    """Guidance faults planted in the reference put in the program's
    place (float32, so that only the guidance numbers can see them): the
    step taken against the gradient, and the energy taken against the
    recording of the next step."""
    from benchmark import check
    from benchmark.reference.pipeline import guidance_update

    class Negated(check.Candidate):
        def guidance(self, chk, i, it, fgw, bgw):
            nxt, acts = super().guidance(chk, i, it, fgw, bgw)
            z = chk.G[i][it].float().to(nxt.device)
            return 2 * z - nxt, acts

    class WrongStep(check.Candidate):
        def guidance(self, chk, i, it, fgw, bgw):
            sh = self.sh
            return guidance_update(
                self.unet, chk.G[i][it], chk.depth64,
                int(sh.sched.timesteps[i]), sh.cond,
                self.orig(chk, min(i + 1, chk.steps - 1)), chk.pcs, fgw,
                bgw, sh.gd)

    return {"negated": Negated, "wrong_step": WrongStep}


def control_readings(chk, sh, weights):
    from benchmark import check, harness
    arch = harness.load_module("archs", sh.cfg["arch"])
    ctl = arch.reference_models(sh.cfg, weights, sh.device)
    fp8_(ctl.unet)
    fp8_(ctl.vae)
    if not isinstance(chk, check.EditCheck):
        return chk.readings(ctl.unet, ctl.vae)
    out = chk.readings(check.Candidate(sh, ctl.unet, ctl.vae,
                                       torch.bfloat16))
    del ctl
    for name, cls in _faults().items():
        fault = cls(sh, sh.ref.unet, sh.ref.vae, torch.float32)
        out["fault_" + name] = chk.readings(
            fault, only=("guidance", "guidance_fwd"))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    from benchmark import harness
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            r = harness.run_cell(spec, args.workload, seed, args.seconds,
                                 False, args.device, t0,
                                 control=control_readings)
            line = json.dumps({
                "workload": args.workload, "seed": seed,
                "program": {n: c["value"] for n, c in r["compared"].items()},
                "control": r["control"],
                "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
