"""The rank processes of tests/test_torch_port_parallel.py: each joins a
gloo process group on the CPU, builds the port's tiny handles on the
rig's weights (handed over in a file) and writes what it computed. Imports
no JAX, so that a rank starts in seconds."""

import os

import torch


def _latents_grad(unet, x, t, ctx, weights):
    """eps, the activations and the latents' gradient of
    sum(eps^2) + sum_k <acts_k, weights_k>."""
    lat = x.clone().requires_grad_(True)
    eps, acts, _ = unet(lat, t, ctx)
    energy = (eps ** 2).sum() + sum((a * w).sum()
                                    for a, w in zip(acts, weights))
    (grad,) = torch.autograd.grad(energy, lat)
    return eps.detach(), [a.detach() for a in acts], grad


def run_rank(rank: int, world: int, port: int, payload: str, out_dir: str):
    """One rank of a (world / 2, 2) mesh: the tiny U-Net's forward and
    latents gradient replicated and sharded over the model axis, then
    edit_batch over the mesh, and the same call with a batch the data axis
    does not divide."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from diffusionhandles_tpu_torch import config as tconfig
    from diffusionhandles_tpu_torch.models.unet import UNet2DConditionModel
    from diffusionhandles_tpu_torch.parallel.batch import edit_batch
    from diffusionhandles_tpu_torch.parallel.distributed import \
        init_distributed
    from diffusionhandles_tpu_torch.parallel.mesh import make_mesh
    from diffusionhandles_tpu_torch.parallel.sharding import shard_unet
    from diffusionhandles_tpu_torch.pipeline import DiffusionHandles

    p = torch.load(payload, weights_only=False)
    info = init_distributed(f"localhost:{port}", world, rank, device="cpu")
    mesh = make_mesh(world, model_parallel=2, device="cpu")
    h = DiffusionHandles(tconfig.config_from_dict(p["config"]),
                         variant="tiny", device="cpu")
    m = h.diffuser.models
    for module, key in ((m.unet, "unet"), (m.vae, "vae"),
                        (m.text_encoder, "text")):
        module.load_state_dict(p[key], strict=True)
    out = {"info": info, "coords": (mesh.get_local_rank("data"),
                                    mesh.get_local_rank("model"))}

    unet = m.unet
    with torch.device("meta"):
        tp = UNet2DConditionModel(unet.config)
    tp.load_state_dict(unet.state_dict(), assign=True)
    shard_unet(tp.eval().requires_grad_(False), mesh)
    args = (p["x"], p["t"], p["ctx"], p["weights"])
    out["replicated"] = _latents_grad(unet, *args)
    out["tp"] = _latents_grad(tp, *args)
    out["param_bytes"] = [sum(q.numel() * q.element_size()
                              for q in net.parameters())
                          for net in (tp, unet)]

    out["images"] = edit_batch(h, *p["edit_args"], p["transforms"], mesh)
    try:
        edit_batch(h, *p["edit_args"], p["transforms"][:3], mesh)
    except ValueError as exc:
        out["uneven"] = str(exc)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
