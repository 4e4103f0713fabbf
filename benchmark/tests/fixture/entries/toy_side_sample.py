"""An entry of the toy_side family alone (archs/toy_side.py): a few seeded
classifier-free-guidance DDIM steps of the side-conditioned denoiser on
the request's depth map, with the port's schedule and step. Its check
re-runs each recorded call on the family's plain float32 reference."""

import functools
import json
import pathlib

import torch

from benchmark import check, counting, harness, traffic
from benchmark.reference.pipeline import seeded_start_latents

FIXTURE = pathlib.Path(__file__).resolve().parents[1]


def setup(session) -> dict:
    _sample(session.handles, session.cfg, session.mix,
            traffic.request(session.mix, session.res, session.seed,
                            traffic.WARMUP))
    return {}


def serve(session, state: dict, request: dict):
    return _sample(session.handles, session.cfg, session.mix, request)


def _sample(handles, cfg: dict, mix: dict, request: dict):
    from diffusionhandles_tpu_torch.scheduler import (add_noise, ddim_step,
                                                      make_ddim_schedule)
    from diffusionhandles_tpu_torch.utils.rng import seeded_randn
    s, dev = cfg["sampler"], handles.device
    sched = make_ddim_schedule(s["num_timesteps"])
    ctx, pooled = handles.encode(["", mix["prompt"]])
    depth = torch.as_tensor(request["photo"]["depth"], device=dev)
    res = cfg["denoiser"]["sample_size"]
    shape = (1, cfg["denoiser"]["out_channels"], res, res)
    z = add_noise(sched, torch.zeros(shape, device=dev),
                  seeded_randn(shape, s["seed"], device=dev),
                  int(sched.timesteps[0]))
    with torch.no_grad():
        for i in range(s["num_timesteps"]):
            eps, _, _ = handles.denoiser(
                torch.cat([z, z]), torch.tensor(int(sched.timesteps[i]),
                                                device=dev),
                ctx, torch.cat([depth, depth]), pooled)
            eps_u, eps_c = eps.chunk(2)
            z = ddim_step(sched, eps_u + s["guidance_scale"]
                          * (eps_c - eps_u), i, z)
    return (z,)


def units(request: dict) -> int:
    return 1


@functools.lru_cache(maxsize=None)
def _call_flops(cfg_json: str, batch: int) -> float:
    """FLOPs of one forward at `batch`, counted on the reference."""
    cfg = json.loads(cfg_json)
    arch = harness.load_module("archs", cfg["arch"], FIXTURE)
    den, _ = arch.reference_models(cfg)
    d, res, w = cfg["denoiser"], cfg["image_res"], cfg["text"]["width"]
    dev = torch.device("meta")
    return counting._counted(lambda: den(
        torch.zeros(batch, d["in_channels"], d["sample_size"],
                    d["sample_size"], device=dev),
        torch.zeros((), device=dev),
        torch.zeros(batch, cfg["text"]["max_length"], w, device=dev),
        torch.zeros(batch, 1, res, res, device=dev),
        torch.zeros(batch, w, device=dev)))


def flops(cfg_json: str, served) -> float:
    return sum(_call_flops(cfg_json, c.batch) for c in served.calls)


def readings(sh, inp) -> dict:
    """"start": the first call's latents against the reference's seeded
    start; "steps": each call re-run on the reference, its CFG DDIM step
    against the latents the program went on with (the next call's, and the
    output after the last), pooled over the steps."""
    s, cfg = inp.served, inp.cfg
    calls, (final,) = s.calls, s.outputs
    n = cfg["sampler"]["num_timesteps"]
    if len(calls) != n or any(c.grad or c.batch != 2 for c in calls):
        raise ValueError(f"{len(calls)} calls, {n} CFG calls expected")
    den, dev = sh.ref.denoiser, sh.device
    depth = torch.as_tensor(s.request["photo"]["depth"], device=dev)
    ctx = torch.cat([sh.uncond, sh.cond])
    pooled = sh.ref.pooled.flip(0)  # [uncond, cond]
    start = seeded_start_latents(sh.sched, calls[0].latents[:1].shape,
                                 cfg["sampler"]["seed"], dev)
    steps = check.Steps()
    for i, c in enumerate(calls):
        z = c.latents[:1].float().to(dev)
        t = int(sh.sched.timesteps[i])
        with torch.no_grad():
            eps, _ = den(torch.cat([z, z]), torch.tensor(t, device=dev),
                         ctx, torch.cat([depth, depth]), pooled)
            eps_u, eps_c = eps.chunk(2)
            want = sh.sched.step(eps_u + cfg["sampler"]["guidance_scale"]
                                 * (eps_c - eps_u), t, z)
        got = calls[i + 1].latents[:1] if i + 1 < n else final
        steps.add(z, got, want)
    return {"start": check.rel(calls[0].latents[:1], start),
            "steps": steps.pooled()}
