"""Entry: one photo inverted, `invert_input_image` then
`generate_input_image` (which serves the inversion's fused capture), on
the request's own photo.

Set-up warms every shape of a request through a two-step copy of the
program's loops on the same models (the VAE encode, DDIM inversion
forwards, null-text inner steps with their backward to the text context,
CFG passes at batch 2 with the recording)."""

import torch

from benchmark import check, counting, traffic


def setup(session) -> dict:
    _invert(session.arch.warmup_handles(session.cfg, session.handles),
            session.mix, traffic.request(session.mix, session.res,
                                         session.seed, traffic.WARMUP))
    return {}


def serve(session, state: dict, request: dict):
    return _invert(session.handles, session.mix, request)


def _invert(handles, mix: dict, request: dict):
    photo = request["photo"]
    null, noise = handles.invert_input_image(photo["img"], photo["depth"],
                                             mix["prompt"])
    null, noise, acts, latents = handles.generate_input_image(
        photo["depth"], mix["prompt"], null, noise)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return null, noise, acts, latents


def units(request: dict) -> int:
    return 1


def flops(cfg_json: str, served) -> float:
    """The U-Net calls as counted (a null-text call's backward to the text
    context only) and the VAE encode."""
    total = sum(counting.unet_call_flops(cfg_json, c.batch,
                                         "context" if c.grad else "")
                for c in served.calls)
    return total + counting.vae_flops(cfg_json, "encode")


def readings(sh, inp) -> dict:
    """The check's readings of the request drawn for it
    (check.InvertCheck)."""
    s = inp.served
    null, noise, acts, final = s.outputs
    chk = check.InvertCheck(sh, inp.mix, s.request["photo"], s.calls, null,
                            noise, acts, final, inp.seed)
    out = chk.readings()
    if inp.control is not None:
        out["control"] = inp.control(chk, sh, inp.weights)
    return out
