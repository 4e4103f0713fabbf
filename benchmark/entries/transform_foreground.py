"""Entry: one edit, `DiffusionHandles.transform_foreground` on the
set-up's photo with the request's transform (a request of one row).

Set-up records the photo once (`generate_input_image`, 50 CFG passes, no
inversion: the guided work of an edit depends on the depth and the
transform, not on the inversion's output), then warms every shape of a
request through a two-step copy of the program's loops on the same models
(one guidance forward and backward, CFG passes at batch 2, the depth
transform, the VAE decode). The tap keeps the activations of the guidance
calls that the check samples."""

from benchmark import check, counting, traffic


def setup(session, serve_with=None) -> dict:
    """The recording and the warm-up; `serve_with(handles, mix, state,
    request)` serves the warm-up request (by default as `serve` does)."""
    h, mix, cfg = session.handles, session.mix, session.cfg
    photo = traffic.photo(mix, session.res, session.seed, 0)
    rec_calls = session.tap.begin()
    null, noise, acts, latents = h.generate_input_image(photo["depth"],
                                                        mix["prompt"])
    state = dict(photo=photo, null=null, noise=noise, acts=acts,
                 latents=latents, rec_calls=rec_calls)
    gd = cfg["guided_diffuser"]
    session.tap.keep = {
        check.guidance_call_index(i, it, gd["num_optsteps"])
        for i, it in check.edit_samples(mix, gd, session.seed)["guidance"]}
    session.tap.begin()
    (serve_with or _edit)(
        session.arch.warmup_handles(cfg, h), mix, state,
        traffic.request(mix, session.res, session.seed, traffic.WARMUP))
    return state


def serve(session, state: dict, request: dict):
    return _edit(session.handles, session.mix, state, request)


def _edit(handles, mix: dict, state: dict, request: dict):
    photo, (tr,) = state["photo"], request["transforms"]
    return handles.transform_foreground(
        depth=photo["depth"], prompt=mix["prompt"],
        fg_mask=photo["fg_mask"], bg_depth=photo["bg_depth"],
        null_text_emb=state["null"], init_noise=state["noise"],
        activations=state["acts"], rot_angle=tr["rotation_angle"],
        rot_axis=tr["rotation_axis"], translation=tr["translation"])


def units(request: dict) -> int:
    return len(request["transforms"])


def flops(cfg_json: str, served) -> float:
    """The U-Net calls as counted (a guidance call's backward to the
    latents only) and one VAE decode per edit."""
    total = sum(counting.unet_call_flops(cfg_json, c.batch,
                                         "latents" if c.grad else "")
                for c in served.calls)
    return total + served.units * counting.vae_flops(cfg_json, "decode")


def readings(sh, inp) -> dict:
    """The check's readings of the request drawn for it (check.EditCheck)."""
    state, s = inp.state, inp.served
    images, disparities = s.outputs
    chk = check.EditCheck(
        sh, inp.mix, state["photo"],
        check.parse_recording(state["rec_calls"],
                              sh.gd["num_timesteps"]),
        state["acts"], state["latents"], s.request["transforms"], s.calls,
        images, disparities, inp.seed)
    out = chk.readings()
    if inp.control is not None:
        out["control"] = inp.control(chk, sh, inp.weights)
    return out

