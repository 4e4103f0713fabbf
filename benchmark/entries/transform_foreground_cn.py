"""Entry: one edit of a model family whose denoiser is a ControlNet and a
U-Net (`archs/sdxl_depth_cn.py`), `DiffusionHandles.transform_foreground`
on the set-up's photo with the request's transform, set up and served as
`transform_foreground`'s. It brings the family's FLOPs (the denoiser's
calls, the VAE decode) and its check (the arch's `ControlEditCheck`). It
notes the traced request's trace session for the readers of device time
inside program spans (`trace_spans.py`)."""

import json

from benchmark import check, counting, harness, trace_spans

_edit = harness.load_entry("transform_foreground")
setup, units = _edit.setup, _edit.units
_ARCHS = {}


def _arch(name: str):
    if name not in _ARCHS:
        _ARCHS[name] = harness.load_module("archs", name)
    return _ARCHS[name]


def serve(session, state: dict, request: dict):
    trace_spans.note(session.tap)
    return _edit.serve(session, state, request)


def flops(cfg_json: str, served) -> float:
    """The denoiser calls as counted (a guidance call's backward to the
    latents only, through both nets) and one VAE decode per edit."""
    arch = _arch(json.loads(cfg_json)["arch"])
    total = sum(arch.call_flops(cfg_json, c.batch,
                                "latents" if c.grad else "")
                for c in served.calls)
    return total + served.units * counting.vae_flops(cfg_json, "decode")


def readings(sh, inp) -> dict:
    """The check's readings of the request drawn for it (the arch's
    ControlEditCheck)."""
    state, s = inp.state, inp.served
    images, disparities = s.outputs
    chk = _arch(sh.cfg["arch"]).ControlEditCheck(
        sh, inp.mix, state["photo"],
        check.parse_recording(state["rec_calls"], sh.gd["num_timesteps"]),
        state["acts"], state["latents"], s.request["transforms"], s.calls,
        images, disparities, inp.seed)
    out = chk.readings()
    if inp.control is not None:
        out["control"] = inp.control(chk, sh, inp.weights)
    return out
