"""The SDXL family of the port (SDXL base 1.0 with the depth ControlNet)
against the plain oracle `torch_oracle_sdxl.py`, at a tiny SDXL-shaped
size on the CPU; and SD-2's U-Net against its previous forward.

Both sides hold the same seeded weights (the port's state dicts, loaded
strictly into the oracle, which proves the names), in float32. Each
comparison is the relative error |port - oracle| / |oracle| under 1e-4:
the two sides sum in other orders (the oracle's einsum attention against
the port's attention op, its stock modules against the port's layers),
which moves float32 results by about 1e-6 relative, while a missing
residual, embedding, tower layer or loss term moves them by order one.
This file imports nothing of JAX.
"""

import hashlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusionhandles_tpu_torch.diffuser import seeded_init_
from diffusionhandles_tpu_torch.guidance import (background_orig_precompute,
                                                 foreground_orig_precompute)
from diffusionhandles_tpu_torch.models import unet as tunet
from diffusionhandles_tpu_torch.models.controlnet import control_image
from diffusionhandles_tpu_torch.pipeline import DiffusionHandles
from torch_oracle_pipeline import (OracleDDIMSchedule, OracleWeightSchedule,
                                   oracle_background_loss,
                                   oracle_foreground_loss,
                                   oracle_process_correspondences)
from torch_oracle_sdxl import (OracleControlNet, OracleXLTower, OracleXLUNet,
                               XLCLIPConfig, XLUNetConfig, encode_prompt_xl)

RTOL = 1e-4
STEPS = 4
PROMPT = "a toy cube on a table"
CONF = {"guided_diffuser": {
    "num_timesteps": STEPS, "guidance_max_step": 3, "num_optsteps": 2,
    "dtype": "float32", "param_dtype": "float32",
    "activation_store_dtype": "float32"},
    "model_paths": {"model_name": "stabilityai/stable-diffusion-xl-base-1.0"}}


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    """Tiny ops: one thread each, as the suite's workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


class Rig:
    """The port's tiny SDXL handles on seeded weights, the oracle on the
    same weights, a photo, its depth and a prompt's ids."""

    def __init__(self):
        torch.manual_seed(0)
        self.h = DiffusionHandles(CONF, variant="tiny", device="cpu")
        d = self.h.diffuser
        m = d.models
        u = m.unet_config
        ocfg = XLUNetConfig(
            sample_size=u.sample_size, block_out_channels=u.block_out_channels,
            layers_per_block=u.layers_per_block, num_heads=u.num_heads,
            cross_attention_dim=u.cross_attention_dim,
            norm_num_groups=u.norm_num_groups,
            transformer_layers_per_block=u.transformer_layers_per_block,
            addition_time_embed_dim=u.addition_time_embed_dim,
            projection_class_embeddings_input_dim=(
                u.projection_class_embeddings_input_dim))
        cn = m.controlnet.cn_config
        self.unet = OracleXLUNet(ocfg)
        self.cn = OracleControlNet(
            ocfg, cn.conditioning_embedding_out_channels,
            cn.conditioning_scale)

        def tower(c):
            return OracleXLTower(XLCLIPConfig(
                vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                intermediate_size=c.intermediate_size, num_heads=c.num_heads,
                num_layers=c.num_layers, hidden_act=c.hidden_act,
                projection_dim=c.projection_dim))
        self.tower_l = tower(m.clip_config)
        self.tower_g = tower(m.clip2_config)
        for mine, theirs in ((self.unet, m.unet), (self.cn, m.controlnet),
                             (self.tower_l, m.text_encoder),
                             (self.tower_g, m.text_encoder_2)):
            mine.load_state_dict(theirs.state_dict(), strict=True)
            mine.eval().requires_grad_(False)
        self.sched = OracleDDIMSchedule(STEPS)
        res = d.image_res
        yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
        self.depth = (2.0 + 0.01 * yy).astype(np.float32)[None, None]
        box = (yy >= res // 3) & (yy < 2 * res // 3) & (xx >= res // 3) \
            & (xx < 2 * res // 3)
        self.depth[0, 0][box] -= 0.4
        self.fg = box.astype(np.float32)[None, None]
        self.img = np.random.default_rng(0).random((1, 3, res, res),
                                                   dtype=np.float32)
        self.ids = torch.tensor(m.tokenizer([PROMPT]))
        self.time_ids = torch.tensor([[res, res, 0, 0, res, res]],
                                     dtype=torch.float32)

    def control(self, disparity):
        """The oracle's control image: the model card's normalisation."""
        d = torch.as_tensor(disparity, dtype=torch.float32)
        d = (d - d.min()) / (d.max() - d.min())
        return d.expand(-1, 3, -1, -1)

    def denoise(self, lat, t, ctx, control, pooled):
        b = lat.shape[0]
        t = torch.tensor(int(t))
        ids = self.time_ids.expand(b, -1)
        control = control.expand(b, -1, -1, -1)
        down, mid = self.cn(lat, t, ctx, control, pooled, ids)
        return self.unet(lat, t, ctx, pooled, ids, down, mid)

    def prompt(self):
        with torch.no_grad():
            return encode_prompt_xl(self.tower_l, self.tower_g, self.ids)

    def disparity(self):
        return self.h._disparity(self.depth)


@pytest.fixture(scope="module")
def rig():
    return Rig()


def _check_text(rig):
    d = rig.h.diffuser
    ctx, pooled = rig.prompt()
    assert _rel(d.encode_prompt(PROMPT), ctx) < RTOL
    assert _rel(d.pooled_prompt(PROMPT), pooled) < RTOL
    # the unconditional row: zeros, context and pooled vector alike
    assert not d.uncond_embedding().any()
    assert d.uncond_embedding().shape == ctx.shape


def _inputs(rig, b=2, seed=1):
    gen = torch.Generator().manual_seed(seed)
    d = rig.h.diffuser
    lat = torch.randn(b, 4, d.latent_res, d.latent_res, generator=gen)
    ctx = torch.randn(b, 77, d.models.unet_config.cross_attention_dim,
                      generator=gen)
    pooled = torch.randn(b, d.models.clip2_config.projection_dim,
                         generator=gen)
    return lat, ctx, pooled


def _check_unet(rig):
    """The U-Net with a ControlNet's residuals and the added conditions."""
    m = rig.h.diffuser.models
    lat, ctx, pooled = _inputs(rig)
    t = torch.tensor(500)
    gen = torch.Generator().manual_seed(2)
    res = [torch.randn(2, c, *s.shape[-2:], generator=gen)
           for c, s in zip(m.controlnet.skip_channels, _skip_shapes(m, lat))]
    mid = torch.randn(2, m.unet_config.block_out_channels[-1],
                      *res[-1].shape[-2:], generator=gen)
    ids = rig.time_ids.expand(2, -1)
    eps, acts, _ = m.unet._forward(lat, t, ctx, False, pooled, ids, res, mid)
    want_eps, want_acts = rig.unet(lat, t, ctx, pooled, ids, res, mid)
    assert len(acts) == len(want_acts) == 2
    assert _rel(eps, want_eps) < RTOL
    for a, w in zip(acts, want_acts):
        assert _rel(a, w) < RTOL
    # the residuals and the added embedding reach the output
    plain, _, _ = m.unet._forward(lat, t, ctx, False, pooled, ids)
    assert _rel(plain, eps) > 1e-3
    other, _, _ = m.unet._forward(lat, t, ctx, False, pooled * 0, ids, res,
                                  mid)
    assert _rel(other, eps) > 1e-3


def _skip_shapes(m, lat):
    with torch.no_grad():
        x = m.unet.conv_in(lat)
        temb = m.unet._embed(torch.tensor(1), lat,
                             torch.zeros(lat.shape[0], 40),
                             torch.zeros(lat.shape[0], 6))
        _, skips, _, _ = m.unet._encode(x, temb, torch.zeros(
            lat.shape[0], 77, m.unet_config.cross_attention_dim), False)
    return skips


def _check_controlnet(rig):
    m = rig.h.diffuser.models
    lat, ctx, pooled = _inputs(rig)
    control = rig.control(rig.disparity()).expand(2, -1, -1, -1)
    t = torch.tensor(300)
    ids = rig.time_ids.expand(2, -1)
    down, mid = m.controlnet(lat, t, ctx, control, pooled, ids)
    want_down, want_mid = rig.cn(lat, t, ctx, control, pooled, ids)
    assert len(down) == len(want_down) == len(m.controlnet.skip_channels)
    for a, w in zip(down + [mid], want_down + [want_mid]):
        assert _rel(a, w) < RTOL
    # the control image reaches the residuals
    down0, _ = m.controlnet(lat, t, ctx, control * 0, pooled, ids)
    assert _rel(down0[0], down[0]) > 1e-3


def _check_cfg_step(rig):
    """One CFG DDIM step at batch 2 through ControlNet and U-Net: the next
    latents and the cond row's activations."""
    d = rig.h.diffuser
    lat, _, _ = _inputs(rig, b=1, seed=3)
    ctx, pooled = rig.prompt()
    dc = d.depth_cond(rig.disparity())
    control = rig.control(rig.disparity())
    assert _rel(dc, control) < RTOL
    i = 1
    with torch.no_grad():
        got, acts = d.cfg_step(lat, dc, d.uncond_embedding()[0],
                               d.encode_prompt(PROMPT), i,
                               d.pooled_prompt(PROMPT))
        t = int(rig.sched.timesteps[i])
        eps, want_acts = rig.denoise(
            torch.cat([lat, lat]), t,
            torch.cat([torch.zeros_like(ctx), ctx]), control,
            torch.cat([torch.zeros_like(pooled), pooled]))
        want = rig.sched.step(eps[:1] + 7.5 * (eps[1:] - eps[:1]), t, lat)
    assert _rel(got - lat, want - lat) < RTOL
    for a, w in zip(acts, want_acts):
        assert _rel(a[1:], w[1:]) < RTOL


def _check_guidance(rig):
    """One guided iteration's gradient to the latents, through both nets:
    the energy of the two recorded stacks under the schedule's last two
    layer weights."""
    d = rig.h.diffuser
    conf = d.conf
    lat, _, _ = _inputs(rig, b=1, seed=4)
    orig_lat, _, _ = _inputs(rig, b=1, seed=5)
    ctx, pooled = rig.prompt()
    dc = d.depth_cond(rig.disparity())
    control = rig.control(rig.disparity())
    i, it = 1, 0
    t = int(rig.sched.timesteps[i])
    res, L = d.image_res, d.latent_res
    gen = np.random.default_rng(7)
    corr = np.concatenate([gen.integers(res // 4, 3 * res // 4, (40, 2)),
                           gen.integers(res // 4, 3 * res // 4, (40, 2))],
                          axis=1)
    with torch.no_grad():
        _, orig = rig.denoise(orig_lat, t, ctx, control, pooled)
    orig = [a[0] for a in orig]
    # the port's step
    pc = d.process_correspondences(corr, res, 0)
    size = (L, L)
    fg_pre = [foreground_orig_precompute(a, pc, 1, size) for a in orig]
    bg_pre = [background_orig_precompute(a, pc, 1, size, "global_avg")
              for a in orig]
    from diffusionhandles_tpu_torch.guidance import \
        build_guidance_weight_schedule
    fgw, bgw = build_guidance_weight_schedule(
        conf.fg_weight, conf.bg_weight, conf.guidance_max_step, STEPS,
        conf.num_optsteps, conf.guidance_schedule_type)
    x = lat.clone().requires_grad_(True)
    with torch.enable_grad():
        energy = d.guidance_energy(x, dc, d.encode_prompt(PROMPT), i,
                                   fg_pre, bg_pre, fgw[i, it], bgw[i, it],
                                   pc, d.pooled_prompt(PROMPT))
        (grad,) = torch.autograd.grad(energy, x)
    # the oracle's
    opc = oracle_process_correspondences(corr, res, L)
    ofg, obg = OracleWeightSchedule(conf.fg_weight, conf.bg_weight,
                                    conf.guidance_max_step,
                                    conf.guidance_schedule_type)(i, it)
    y = lat.clone().requires_grad_(True)
    with torch.enable_grad():
        _, acts = rig.denoise(y, t, ctx, control, pooled)
        loss = 0.0
        for k, (a, o) in enumerate(zip(acts, orig)):
            loss = loss + ofg[k + 1] * oracle_foreground_loss(
                a[0], o, opc, 1, size)
            loss = loss + obg[k + 1] * oracle_background_loss(
                a[0], o, opc, 1, size, "global_avg")
        (want,) = torch.autograd.grad(loss, y)
    assert float(want.abs().max()) > 0
    assert _rel(energy, torch.as_tensor(loss)) < RTOL
    assert _rel(grad, want) < RTOL


def _check_inversion(rig):
    """One DDIM inversion step, then one null-text step of one inner
    iteration, both through ControlNet and U-Net."""
    from diffusionhandles_tpu_torch.inverter import StableNullInverter
    d = rig.h.diffuser
    inv = StableNullInverter(d)
    ctx, pooled = rig.prompt()
    dc = d.depth_cond(rig.disparity())
    control = rig.control(rig.disparity())
    lat0 = d.encode_latent_image(rig.img)
    with torch.no_grad():
        traj = inv.ddim_loop(lat0, dc, d.encode_prompt(PROMPT),
                             d.pooled_prompt(PROMPT))
        # the second step: the first (t = 0) moves the latents by
        # rounding alone
        t = int(rig.sched.timesteps[STEPS - 2])
        eps, _ = rig.denoise(traj[1], t, ctx, control, pooled)
        want = rig.sched.next_step(eps, t, traj[1])
    assert _rel(traj[2] - traj[1], want - traj[1]) < RTOL
    uncond0 = d.uncond_embedding()
    seq = inv.null_optimization(traj, dc, uncond0, d.encode_prompt(PROMPT),
                                1, 0.0, pooled=d.pooled_prompt(PROMPT))
    # the oracle's first null-text step: a fresh Adam, one iteration
    i = 0
    t = int(rig.sched.timesteps[i])
    cur, prev = traj[STEPS], traj[STEPS - 1]
    with torch.no_grad():
        eps_c, _ = rig.denoise(cur, t, ctx, control, pooled)
    u = uncond0.clone().requires_grad_(True)
    opt = torch.optim.Adam([u], lr=1e-2)
    with torch.enable_grad():
        eps_u, _ = rig.denoise(cur, t, u, control, torch.zeros_like(pooled))
        rec = rig.sched.step(eps_u + 7.5 * (eps_c - eps_u), t, cur)
        F.mse_loss(rec, prev).backward()
    opt.step()
    assert float((u.detach() - uncond0).abs().max()) > 0
    assert _rel(seq[0] - uncond0, u.detach() - uncond0) < RTOL


CHECKS = {"text_towers": _check_text, "unet": _check_unet,
          "controlnet": _check_controlnet, "cfg_step": _check_cfg_step,
          "guidance": _check_guidance, "inversion": _check_inversion}


@pytest.mark.parametrize("name", list(CHECKS))
def test_sdxl_against_oracle(rig, name):
    CHECKS[name](rig)


def test_sdxl_entry_points(rig):
    """The three public entry points run the family end to end: two
    recorded stacks (640-like and 320-like widths at half and full
    latent resolution), finite outputs."""
    h = rig.h
    null, noise = h.invert_input_image(rig.img, rig.depth, PROMPT)
    assert null.shape[0] == STEPS and noise.shape[1] == 4
    null, noise, acts, lat = h.generate_input_image(rig.depth, PROMPT, null,
                                                    noise)
    L = h.diffuser.latent_res
    assert [tuple(a.shape[-2:]) for a in acts] == [(L // 2, L // 2), (L, L)]
    image, disparity = h.transform_foreground(
        rig.depth, PROMPT, rig.fg, np.full_like(rig.depth, 2.0), null, noise,
        acts, rot_angle=10.0, rot_axis=[0.0, 1.0, 0.0],
        translation=[0.05, 0.0, 0.0])
    assert image.shape == rig.img.shape and np.isfinite(image).all()
    assert disparity.shape == rig.depth.shape


def test_control_image():
    disp = torch.rand(1, 1, 16, 16) * 3 + 1
    img = control_image(disp, 32)
    assert img.shape == (1, 3, 32, 32)
    assert float(img.min()) == 0.0 and float(img.max()) == 1.0
    assert torch.equal(control_image(disp, 16)[0, 2],
                       (disp[0, 0] - disp.min()) / (disp.max() - disp.min()))


# ---------------------------------------------------------------------------
# SD-2's U-Net with the new fields at their defaults
# ---------------------------------------------------------------------------

# sha256 of SD-2's tiny U-Net's parameter names and shapes in registration
# order, as the previous U-Net made them (the seeded weights follow this
# order)
SD2_TINY_LAYOUT = ("ffddd5b9933dd4233e3b4e3b1ea92c3f"
                   "fc560286c9fe96340519ddc4bae1715f")


def _previous_forward(unet, sample, timesteps, context):
    """The SD-2 U-Net's forward as it was before the SDXL fields (its
    encoder split out, the added embedding and the residuals), on the
    same modules."""
    cfg = unet.config
    dt = cfg.dtype
    timesteps = torch.as_tensor(timesteps, device=sample.device)
    if timesteps.ndim == 0:
        timesteps = timesteps.expand(sample.shape[0])
    temb = tunet.timestep_embedding(timesteps, cfg.block_out_channels[0],
                                    cfg.flip_sin_to_cos, cfg.freq_shift)
    temb = unet.time_embedding.linear_1(temb.to(dt))
    temb = unet.time_embedding.linear_2(F.silu(temb))
    context = context.to(dt)
    x = unet.conv_in(sample.to(dt))
    skips = [x]
    for block in unet.down_blocks:
        x, block_skips, _ = block(x, temb, context, False)
        skips.extend(block_skips)
    x, _ = unet.mid_block(x, temb, context, False)
    activations = []
    for i, block in enumerate(unet.up_blocks):
        n = cfg.layers_per_block + 1
        block_skips, skips = skips[-n:], skips[:-n]
        x, _ = block(x, block_skips, temb, context, False)
        if cfg.up_block_types[i] == "CrossAttnUpBlock2D":
            activations.append(x.float())
    eps = unet.conv_out(tunet.gn_silu(unet.conv_norm_out, x, dt))
    return eps.float(), tuple(activations)


@pytest.mark.parametrize("fields", [
    {}, {"transformer_layers_per_block": (), "addition_embed_type": None}],
    ids=["defaults", "defaults_given"])
def test_sd2_unet_bitwise_previous(fields):
    cfg = tunet.tiny_unet_config(**fields)
    torch.manual_seed(0)
    u = tunet.UNet2DConditionModel(cfg).eval()
    seeded_init_(u, torch.Generator().manual_seed(3))
    layout = str([(k, tuple(v.shape)) for k, v in u.state_dict().items()])
    assert hashlib.sha256(layout.encode()).hexdigest() == SD2_TINY_LAYOUT
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 8, 8, generator=gen)
    ctx = torch.randn(2, 77, 32, generator=gen)
    with torch.no_grad():
        eps, acts, _ = u(x, torch.tensor(500), ctx)
        want_eps, want_acts = _previous_forward(u, x, torch.tensor(500), ctx)
    assert torch.equal(eps, want_eps)
    assert len(acts) == 3
    assert all(torch.equal(a, w) for a, w in zip(acts, want_acts))


# ---------------------------------------------------------------------------
# On the card: the ControlNet and U-Net replayed as one graph
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("grad", [False, True], ids=["forward", "latents"])
def test_denoiser_replay_matches_eager(grad):
    """A denoiser call (ControlNet, then U-Net) eager, captured, then
    replayed: each bitwise the eager call on its own inputs, with the
    gradient to the latents where the call records a graph. The tiny fp32
    nets take cuDNN's deterministic algorithms, as the tiny U-Net's replay
    test does: their eager backward otherwise differs from itself run to
    run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from diffusionhandles_tpu_torch.config import (SDXL_DEPTH_CONTROLNET,
                                                   GuidedDiffuserConfig,
                                                   ModelPathsConfig)
    from diffusionhandles_tpu_torch.diffuser import create_sd_models
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        m = create_sd_models(ModelPathsConfig(model_name=SDXL_DEPTH_CONTROLNET),
                             GuidedDiffuserConfig(flash_attention=False),
                             variant="tiny", device="cuda")
        den = m.denoiser
        res = m.unet_config.sample_size * m.vae_config.downscale_factor
        gen = torch.Generator(device="cuda").manual_seed(0)

        def inputs():
            lat = torch.randn(2, 4, 8, 8, generator=gen, device="cuda")
            ctx = torch.randn(2, 77, m.unet_config.cross_attention_dim,
                              generator=gen, device="cuda")
            control = torch.rand(2, 3, res, res, generator=gen,
                                 device="cuda")
            pooled = torch.randn(2, 40, generator=gen, device="cuda")
            ids = torch.full((2, 6), float(res), device="cuda")
            return lat, torch.tensor(500, device="cuda"), ctx, control, \
                pooled, ids

        def call(fn, x):
            lat = x[0].detach().requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                eps, acts, _ = fn(lat, *x[1:])
                if not grad:
                    return [eps, *acts]
                (g,) = torch.autograd.grad(
                    sum(a.square().sum() for a in acts), lat)
            return [eps.detach(), *(a.detach() for a in acts), g]

        xs = [inputs() for _ in range(4)]
        before = dict(tunet.GRAPH_CALLS)
        got = [call(den, x) for x in xs]
        want = [call(lambda *a: den._forward(*a[:3], False, *a[3:]), x)
                for x in xs]
        assert {k: n - before[k] for k, n in tunet.GRAPH_CALLS.items()} == {
            "eager": 1, "capture": 1, "replay": 2}
        for g, w in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(g, w))
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.backends.cudnn.deterministic = deterministic
