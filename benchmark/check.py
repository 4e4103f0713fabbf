"""The comparison that decides `correct`.

The guided loops run 50 steps of a model whose rounding a different
summation order changes, so a whole edit cannot be compared with a
reference edit computed apart: the two trajectories part by more than any
fault shows. The check therefore follows the program step by step from the
program's own state. From the latents that the U-Net received at each call
(read at its module boundary by tap.UNetTap), the plain reference computes
the step that the published algorithm takes there and compares its
outcome with the state the program went on with, for a sample of steps
drawn from the seed. The start (the seeded latents), the stages that this
skips (the text encoder, the depth transform, the correspondence binning,
the recorded activations, the VAE) are worked out by the reference from
the benchmark's own inputs and compared by themselves, and the program's
outputs (the image, the edited disparity, the null-text embeddings) are
what is judged.

Each number is a relative error: |program - reference| over |the
reference's change of the state| in the sampled steps (latents, or the
null-text embedding), pooled over steps and rows; activations and images
over their own norm, the worst of them; the edited disparity as a mean
over pixels. A guidance step is judged in two parts, each from the
program's own state: the activations its forward returned, against the
reference's forward at the same latents (`guidance_fwd`), and the step,
against the reference's gradient of the energy taken at those
activations and carried back through the reference's forward
(`guidance`); the energies are L1 distances, whose gradient flips sign
wherever a residual is near zero, so a step computed from other
activations than the program's would differ by rounding alone (PERF.md).
`null_loss` judges the null-text steps by their effect on the step's
loss, pooled over the sampled steps (`loss_missed`). The candidate is the
program or, for the control, the reference itself computed at a lower
precision (control.py), read through the same functions.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Optional

import numpy as np
import torch

from benchmark import traffic
from benchmark.reference import geometry
from benchmark.reference.pipeline import (RefDDIMSchedule, RefWeightSchedule,
                                          cfg_update, ddim_inversion_update,
                                          guidance_update, init_depth,
                                          null_text_step,
                                          process_correspondences,
                                          seeded_start_latents)

if TYPE_CHECKING:
    from benchmark.archs.sd2_depth import Reference


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst row of |got - want| / |want| (rows: the leading axis)."""
    got = got.float().reshape(got.shape[0], -1)
    want = want.float().reshape(want.shape[0], -1).to(got.device)
    num = torch.linalg.vector_norm(got - want, dim=1)
    den = torch.linalg.vector_norm(want, dim=1).clamp_min(1e-30)
    return float((num / den).max())


class Steps:
    """The relative error of a stage's sampled steps: the norm of
    (candidate - reference) over the norm of the reference's change of
    the state, steps and rows pooled, so that a step that changes the
    state by nearly nothing (DDIM's last step at t = 0) does not divide by
    nothing."""

    def __init__(self):
        self.num, self.den = [], []

    def add(self, z, got, want):
        z = z.float().to(want.device)
        got = got.float().to(want.device)
        self.num.append(float(((got - want) ** 2).sum()))
        self.den.append(float(((want - z) ** 2).sum()))

    def pooled(self) -> float:
        num, den = sum(self.num), sum(self.den)
        if den <= 0:
            return 0.0 if num <= 0 else float("inf")
        return (num / den) ** 0.5


def _disparity(depth) -> torch.Tensor:
    d = torch.as_tensor(np.asarray(depth, np.float32))
    return geometry.normalize_disparity(1.0 / d)


@dataclasses.dataclass
class Shared:
    """What the reference derives once per run from the benchmark's
    inputs (the model family's `shared` builds it)."""

    cfg: dict
    ref: Reference
    sched: RefDDIMSchedule
    cond: torch.Tensor
    uncond: torch.Tensor
    device: torch.device

    @property
    def gd(self) -> dict:
        return self.cfg["guided_diffuser"]

    @property
    def latent_res(self) -> int:
        return self.cfg["unet"]["sample_size"]


def _decode(sh: Shared, latents) -> torch.Tensor:
    with torch.no_grad():
        img = sh.ref.vae.decode(latents.float() / sh.ref.scaling)
    return ((img + 1) / 2).clamp(0, 1)


# ---------------------------------------------------------------------------
# Edit cells: transform_foreground and edit_batch
# ---------------------------------------------------------------------------

def parse_edit_calls(calls, rows: int, steps: int, guided: int,
                     optsteps: int):
    """Split one edit's U-Net calls into guidance inputs G[i][it] with the
    activations those calls returned GA[i][it] (None where the tap kept
    none) and CFG inputs C[i] ([rows, C, h, w] latents), or raise
    ValueError when the calls do not follow the published loop."""
    want = guided * (optsteps + 1) + (steps - guided)
    if len(calls) != want:
        raise ValueError(f"{len(calls)} U-Net calls, the loop makes {want}")
    it = iter(calls)
    G, GA, C = [], [], []
    for i in range(steps):
        g, ga = [], []
        for _ in range(optsteps if i < guided else 0):
            c = next(it)
            if not c.grad or c.batch != rows:
                raise ValueError(f"step {i}: a guidance call expected")
            g.append(c.latents)
            ga.append(c.acts)
        c = next(it)
        if c.grad or c.batch != 2 * rows:
            raise ValueError(f"step {i}: a CFG call expected")
        G.append(g)
        GA.append(ga)
        C.append(c.latents[:rows])
    return G, GA, C


def guidance_call_index(i: int, it: int, optsteps: int) -> int:
    """The index in an edit's U-Net calls of guidance iteration `it` of
    step `i` (< guidance_max_step)."""
    return i * (optsteps + 1) + it


def parse_recording(calls, steps: int):
    """The recording's CFG inputs (row 0) of generate_input_image."""
    if len(calls) != steps or any(c.grad or c.batch != 2 for c in calls):
        raise ValueError(f"the recording made {len(calls)} calls, "
                         f"{steps} CFG calls expected")
    return [c.latents[:1] for c in calls]


def edit_samples(mix: dict, gd: dict, seed: int) -> dict:
    """The steps an edit's check compares, drawn from the seed: guidance
    iterations (i, it), CFG steps and recording steps, each with the first
    and the last."""
    c = mix["check"]
    steps, guided = gd["num_timesteps"], gd["guidance_max_step"]
    gsteps = [(i, it) for i in range(guided)
              for it in range(gd["num_optsteps"])]
    g = traffic.sample_indices(len(gsteps), c["guidance"], seed, 1,
                               keep=(0, -1))
    return dict(
        guidance=[gsteps[k] for k in g],
        cfg=traffic.sample_indices(steps - 1, c["cfg"], seed, 2,
                                   keep=(0, -1)),
        recording=traffic.sample_indices(steps, c["recording"], seed, 3,
                                         keep=(0, -1)))


class EditCheck:
    """Readings of one edit request against the reference.

    setup: the photo, the recording's CFG inputs Z[i] and the program's
    recorded activations (3 stacks [T, C, H, W]) and final latents.
    request: its transforms, its calls (parsed), and the program's images
    [B,3,H,W] and disparities [B,1,H,W]."""

    def __init__(self, sh: Shared, mix: dict, photo: dict, rec_inputs,
                 rec_acts, rec_final, transforms: list, calls,
                 images, disparities, seed: int):
        self.sh, self.mix, self.photo = sh, mix, photo
        self.seed = seed
        gd = sh.gd
        self.steps = gd["num_timesteps"]
        self.guided = gd["guidance_max_step"]
        self.opt = gd["num_optsteps"]
        self.rows = len(transforms)
        self.Z = rec_inputs
        self.rec_acts = rec_acts
        self.rec_final = rec_final
        self.transforms = transforms
        self.G, self.GA, self.C = parse_edit_calls(
            calls, self.rows, self.steps, self.guided, self.opt)
        self.images = torch.as_tensor(np.asarray(images))
        self.disparities = torch.as_tensor(np.asarray(disparities))
        self.weights = RefWeightSchedule(gd["fg_weight"], gd["bg_weight"],
                                         self.guided,
                                         gd["guidance_schedule_type"])
        self.transform = geometry.depth_transform(
            sh.cfg["depth_transform_mode"])
        dev = sh.device
        self.depth64_orig = init_depth(
            _disparity(photo["depth"]).to(dev), sh.latent_res)
        self._acts_orig: Dict[int, list] = {}
        self.geometry(torch.float32)

    def geometry(self, dtype):
        """The reference's edited disparities, depth inputs and binned
        correspondences of the request's transforms (computed in
        `dtype`)."""
        disps, pcs = [], []
        res = int(np.shape(self.photo["depth"])[-1])
        for tr in self.transforms:
            d, corr = self.transform(
                self.photo["depth"], self.photo["bg_depth"],
                self.photo["fg_mask"], tr["rotation_angle"],
                tr["rotation_axis"], tr["translation"], self.sh.device,
                dtype=dtype)
            disps.append(d)
            pcs.append(process_correspondences(
                corr, img_res=res, latent_res=self.sh.latent_res,
                bg_erosion=self.sh.gd["bg_erosion"]))
        self.disp_ref = torch.cat(disps)
        self.pcs = pcs
        self.depth64 = init_depth(self.disp_ref, self.sh.latent_res)
        return self.disp_ref

    def acts_orig(self, unet, i: int) -> list:
        """(`unet`'s recorded activations at recording step i, from the
        program's recording input Z[i], and its next latents)."""
        key = (id(unet), i)
        if key not in self._acts_orig:
            sh = self.sh
            nxt, acts = cfg_update(unet, sh.sched, self.Z[i],
                                   self.depth64_orig,
                                   int(sh.sched.timesteps[i]), sh.uncond,
                                   sh.cond, sh.gd["guidance_scale"])
            store = getattr(torch, sh.gd.get("activation_store_dtype",
                                             "float32"))
            self._acts_orig[key] = ([a[0].to(store).float() for a in acts],
                                    nxt)
        return self._acts_orig[key]

    def _next_of_guidance(self, i, it):
        return self.G[i][it + 1] if it + 1 < self.opt else self.C[i]

    def _next_of_cfg(self, i):
        if i + 1 >= self.steps:
            return None
        return self.G[i + 1][0] if i + 1 < self.guided else self.C[i + 1]

    def samples(self) -> dict:
        return edit_samples(self.mix, self.sh.gd, self.seed)

    def readings(self, candidate: Optional["Candidate"] = None,
                 only=None) -> Dict[str, float]:
        """Each stage's relative error, of the program or of `candidate`
        (with `only`, of those stages alone)."""
        sh, ref = self.sh, self.sh.ref
        s = self.samples()
        gs = sh.gd["guidance_scale"]
        out = {}

        def due(*names):
            return only is None or any(n in only for n in names)

        if due("recording"):
            # the start and the recording
            start = seeded_start_latents(sh.sched, self.Z[0].shape,
                                         sh.gd["seed"], sh.device)
            errs = [rel(self.Z[0], start),
                    rel(self.G[0][0] if self.G[0] else self.C[0],
                        start.expand(self.rows, -1, -1, -1))]
            steps = Steps()
            for i in s["recording"]:
                acts, nxt = self.acts_orig(ref.unet, i)
                if candidate is None:
                    got_acts = [a[i][None] for a in self.rec_acts]
                    got_next = (self.Z[i + 1] if i + 1 < self.steps
                                else self.rec_final)
                else:
                    got_acts, got_next = candidate.recording(self, i)
                errs += [rel(g, a[None]) for g, a in zip(got_acts, acts)]
                steps.add(self.Z[i], got_next, nxt)
            errs.append(steps.pooled())
            out["recording"] = max(errs)
        if due("disparity"):
            # the depth transform: the mean over pixels, since a splat tie
            # broken the other way moves one pixel by up to the depth step
            # of an edge
            disp = (self.disparities if candidate is None
                    else candidate.disparity(self))
            out["disparity"] = float((disp.float().to(sh.device)
                                      - self.disp_ref).abs().mean()) / 255.0
        if due("guidance", "guidance_fwd"):
            # guidance iterations, each from the candidate's own state
            steps, fwd = Steps(), []
            for i, it in s["guidance"]:
                z = self.G[i][it]
                fgw, bgw = self.weights(i, it)
                if candidate is None:
                    got, got_acts = self._next_of_guidance(i, it), \
                        self.GA[i][it]
                    orig = [a[i] for a in self.rec_acts]
                else:
                    got, got_acts = candidate.guidance(self, i, it, fgw, bgw)
                    orig = candidate.orig(self, i)
                if got_acts is None:
                    raise ValueError(f"guidance call ({i}, {it}): its "
                                     "activations were not kept")
                want, acts = guidance_update(
                    ref.unet, z, self.depth64, int(sh.sched.timesteps[i]),
                    sh.cond, orig, self.pcs, fgw, bgw, sh.gd,
                    acts_at=got_acts)
                steps.add(z, got, want)
                fwd += [rel(g, a) for g, a in zip(got_acts, acts)]
            out["guidance_fwd"] = max(fwd)
            out["guidance"] = steps.pooled()
        if due("cfg"):
            steps = Steps()
            for i in s["cfg"]:
                z = self.C[i]
                want, _ = cfg_update(ref.unet, sh.sched, z, self.depth64,
                                     int(sh.sched.timesteps[i]), sh.uncond,
                                     sh.cond, gs)
                got = (self._next_of_cfg(i) if candidate is None
                       else candidate.cfg(self, i))
                steps.add(z, got, want)
            out["cfg"] = steps.pooled()
        if due("image"):
            # the last step and the decode
            last = self.steps - 1
            z_end, _ = cfg_update(ref.unet, sh.sched, self.C[last],
                                  self.depth64,
                                  int(sh.sched.timesteps[last]), sh.uncond,
                                  sh.cond, gs)
            want = _decode(sh, z_end)
            got = (self.images if candidate is None
                   else candidate.image(self))
            out["image"] = rel(got.to(sh.device), want)
        return out


class Candidate:
    """The control: the reference's own steps from the same program state,
    computed by `unet`, `vae` and the geometry in lower precisions."""

    def __init__(self, sh: Shared, unet, vae, geometry_dtype):
        self.sh, self.unet, self.vae = sh, unet, vae
        self.geometry_dtype = geometry_dtype

    def recording(self, chk: EditCheck, i: int):
        acts, nxt = chk.acts_orig(self.unet, i)
        return [a[None] for a in acts], nxt

    def orig(self, chk: EditCheck, i: int) -> list:
        """The activations this candidate recorded at step i."""
        return chk.acts_orig(self.unet, i)[0]

    def disparity(self, chk: EditCheck):
        ref_disp, ref_pcs, ref_d64 = chk.disp_ref, chk.pcs, chk.depth64
        got = chk.geometry(self.geometry_dtype)
        chk.disp_ref, chk.pcs, chk.depth64 = ref_disp, ref_pcs, ref_d64
        return got

    def guidance(self, chk: EditCheck, i, it, fgw, bgw):
        """(the latents after guidance iteration (i, it), the activations
        of its forward)."""
        sh = self.sh
        return guidance_update(
            self.unet, chk.G[i][it], chk.depth64,
            int(sh.sched.timesteps[i]), sh.cond, self.orig(chk, i), chk.pcs,
            fgw, bgw, sh.gd)

    def cfg(self, chk: EditCheck, i):
        sh = self.sh
        out, _ = cfg_update(self.unet, sh.sched, chk.C[i], chk.depth64,
                            int(sh.sched.timesteps[i]), sh.uncond, sh.cond,
                            sh.gd["guidance_scale"])
        return out

    def image(self, chk: EditCheck):
        sh = self.sh
        last = chk.steps - 1
        z, _ = cfg_update(self.unet, sh.sched, chk.C[last], chk.depth64,
                          int(sh.sched.timesteps[last]), sh.uncond, sh.cond,
                          sh.gd["guidance_scale"])
        with torch.no_grad():
            img = self.vae.decode(z / sh.ref.scaling)
        return ((img + 1) / 2).clamp(0, 1)


# ---------------------------------------------------------------------------
# The invert cell: invert_input_image + generate_input_image
# ---------------------------------------------------------------------------

def parse_invert_calls(calls, steps: int, inner: int):
    """Split one inversion's calls: the DDIM inversion's inputs D[i]
    (i = 0..steps-1), and per null-text step the cond pass's input L[i]
    and its inner iterations' count."""
    if len(calls) < 2 * steps:
        raise ValueError(f"{len(calls)} U-Net calls in an inversion")
    D = [c.latents for c in calls[:steps]]
    if any(c.grad or c.batch != 1 for c in calls[:steps]):
        raise ValueError("the DDIM inversion's calls are not forwards")
    L, J = [], []
    k = steps
    for i in range(steps):
        c = calls[k]
        if c.grad:
            raise ValueError(f"null-text step {i}: a cond pass expected")
        L.append(c.latents)
        k += 1
        j = 0
        while k < len(calls) and calls[k].grad:
            j += 1
            k += 1
        if not 1 <= j <= inner or k >= len(calls) or calls[k].grad:
            raise ValueError(f"null-text step {i}: {j} inner iterations")
        J.append(j)
        k += 1  # the uncond pass of the CFG step
    if k != len(calls):
        raise ValueError(f"{len(calls) - k} U-Net calls past the loop")
    return D, L, J


def loss_missed(losses) -> float:
    """The share of the reference's fall of the null-text loss that the
    candidate's embeddings miss: over steps of (loss of the embedding
    before the step, of the reference's, of the candidate's), the sum of
    each step's excess over the reference's loss (a step where the
    candidate's loss is lower counts 0) over the sum of the reference's
    falls. Pooled, because near t = 0 a step's fall lies under the
    loss's float32 rounding, where a step's own ratio is one rounding
    over another."""
    missed = sum(max(got - want, 0.0) for _, want, got in losses)
    fall = sum(before - want for before, want, _ in losses)
    if fall <= 0:
        return 0.0 if missed <= 0 else float("inf")
    return missed / fall


def _null_loss(unet, sched, step, latent_cur, latent_prev, depth64, uncond,
               cond, gs) -> float:
    """The null-text loss of `uncond` at `step`: the mean squared error of
    the CFG step's result against the inversion's latent."""
    t = int(sched.timesteps[step])
    nxt, _ = cfg_update(unet, sched, latent_cur, depth64, t, uncond, cond,
                        gs)
    return float(((nxt - latent_prev.float()) ** 2).mean())


class InvertCheck:
    """Readings of one inversion request: the program's outputs are the
    null-text embeddings [T,1,77,D], the init noise, the recorded
    activations (3 stacks) and the final latents."""

    def __init__(self, sh: Shared, mix: dict, photo: dict, calls, null,
                 noise, acts, final, seed: int, inner: int = 5):
        self.sh, self.mix, self.photo, self.seed = sh, mix, photo, seed
        self.steps = sh.gd["num_timesteps"]
        self.D, self.L, self.J = parse_invert_calls(calls, self.steps,
                                                    inner)
        self.null, self.noise = null, noise
        self.acts, self.final = acts, final
        self.inner = inner
        self.depth64 = init_depth(_disparity(photo["depth"]).to(sh.device),
                                  sh.latent_res)

    def samples(self) -> dict:
        c = self.mix["check"]
        n = self.steps
        return dict(
            inversion=traffic.sample_indices(n, c["inversion"], self.seed,
                                             4, keep=(0, -1)),
            null_text=traffic.sample_indices(n, c["null_text"], self.seed,
                                             5, keep=(0, -1)),
            cfg=traffic.sample_indices(n, c["cfg"], self.seed, 6,
                                       keep=(0, -1)),
            recording=traffic.sample_indices(n, c["recording"], self.seed,
                                             7, keep=(0, -1)))

    def _uncond_before(self, i: int) -> torch.Tensor:
        return self.sh.uncond if i == 0 else self.null[i - 1].reshape(
            1, *self.null.shape[-2:])

    def readings(self, unet=None, vae=None) -> Dict[str, float]:
        """Each stage's relative error; with `unet` and `vae`, the
        control's instead of the program's."""
        sh = self.sh
        ref_unet, ctl = sh.ref.unet, unet is not None
        unet = unet or ref_unet
        sched, gs = sh.sched, sh.gd["guidance_scale"]
        s = self.samples()
        out = {}
        img = torch.as_tensor(self.photo["img"], device=sh.device)
        with torch.no_grad():
            lat0 = sh.ref.vae.encode_mean(img * 2 - 1) * sh.ref.scaling
            got0 = ((vae.encode_mean(img * 2 - 1) * sh.ref.scaling)
                    if ctl else self.D[0])
        out["encode"] = rel(got0, lat0)
        # DDIM inversion steps: the trajectory is D[0..T-1], then the noise
        traj = self.D + [self.noise.reshape(self.D[0].shape)]
        steps = Steps()
        for i in s["inversion"]:
            t = int(sched.timesteps[self.steps - 1 - i])
            want = ddim_inversion_update(ref_unet, sched, traj[i],
                                         self.depth64, t, sh.cond)
            got = (ddim_inversion_update(unet, sched, traj[i], self.depth64,
                                         t, sh.cond) if ctl
                   else traj[i + 1])
            steps.add(traj[i], got, want)
        out["inversion"] = steps.pooled()
        # null-text optimisation, from the program's embedding before it:
        # the change of the embedding, and the share of the reference's
        # fall of the steps' loss that the program's embeddings miss
        steps, losses = Steps(), []
        for i in s["null_text"]:
            latent_prev = traj[self.steps - 1 - i]
            u0 = self._uncond_before(i)
            want, _ = null_text_step(ref_unet, sched, i, self.L[i],
                                     latent_prev, self.depth64, u0, sh.cond,
                                     gs, self.inner)
            got = (null_text_step(unet, sched, i, self.L[i], latent_prev,
                                  self.depth64, u0, sh.cond, gs,
                                  self.inner)[0] if ctl
                   else self.null[i].reshape(want.shape))
            steps.add(u0, got, want)
            losses.append([_null_loss(ref_unet, sched, i, self.L[i],
                                      latent_prev, self.depth64, u, sh.cond,
                                      gs) for u in (u0, want, got)])
        out["null_text"] = steps.pooled()
        out["null_loss"] = loss_missed(losses)
        # CFG steps with the optimised embeddings, and the recording
        steps, aerrs = Steps(), []
        for i in sorted(set(s["cfg"]) | set(s["recording"])):
            u = self.null[i].reshape(1, *self.null.shape[-2:])
            t = int(sched.timesteps[i])
            want, acts = cfg_update(ref_unet, sched, self.L[i], self.depth64,
                                    t, u, sh.cond, gs)
            if ctl:
                got, got_acts = cfg_update(unet, sched, self.L[i],
                                           self.depth64, t, u, sh.cond, gs)
            else:
                got = self.L[i + 1] if i + 1 < self.steps else self.final
                got_acts = [a[i][None] for a in self.acts]
            if i in s["cfg"]:
                steps.add(self.L[i], got, want)
            if i in s["recording"]:
                aerrs += [rel(g, a) for g, a in zip(got_acts, acts)]
        out["cfg"] = steps.pooled()
        out["recording"] = max(aerrs)
        return out
