"""Multi-GPU editing of the PyTorch port on the CPU: the process group,
the mesh, the U-Net's tensor parallelism and edit_batch over a mesh, held
to the JAX package's `parallel/` modules.

The port runs one process a rank over gloo here (NCCL on the card): one
`torch.multiprocessing` spawn of 4 ranks, a (data 2, model 2) mesh, each
rank on one thread, runs the tiny U-Net's forward and latents gradient
sharded over the model axis and edit_batch over the mesh; the parent
holds them to the replicated port and to JAX on its 8 virtual CPU
devices, in the bands of tests/test_tensor_parallel.py (forward rtol 2e-4
/ atol 2e-5; gradient, and the edit's images, rtol 5e-3 / atol 2e-3 x the
largest value). The specs are held to JAX `param_spec` name by name
through the state-dict renaming of models/weights.py.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from diffusionhandles_tpu.models import unet as junet
from diffusionhandles_tpu.parallel import sharding as jsharding
from diffusionhandles_tpu.parallel.batch import edit_batch as jedit_batch
from diffusionhandles_tpu.parallel.mesh import make_mesh as jmake_mesh
from diffusionhandles_tpu_torch import config as tconfig
from diffusionhandles_tpu_torch.models import unet as tunet
from diffusionhandles_tpu_torch.models import weights as tweights
from diffusionhandles_tpu_torch.parallel import sharding as tsharding
from diffusionhandles_tpu_torch.parallel.mesh import make_mesh
from torch_port_parallel_worker import run_rank
from torch_port_rig import PROMPT, make_rig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_BAND = dict(rtol=2e-4, atol=2e-5)
TRANSFORMS = [  # the first and third are twins, on different data ranks
    {"rotation_angle": 10.0, "rotation_axis": [0, 1, 0],
     "translation": [0.0, 0.0, 0.0]},
    {"rotation_angle": 0.0, "rotation_axis": [0, 1, 0],
     "translation": [0.05, 0.0, 0.0]},
    {"rotation_angle": 10.0, "rotation_axis": [0, 1, 0],
     "translation": [0.0, 0.0, 0.0]},
    {"rotation_angle": -5.0, "rotation_axis": [1, 0, 0],
     "translation": [0.0, 0.02, 0.0]},
]
# the attentions of SD-2 whose 5 heads model_parallel 2 does not divide
SD2_REPLICATED = [f"{block}.attentions.{i}.transformer_blocks.0.attn{a}"
                  for block, n in (("down_blocks.0", 2), ("up_blocks.3", 3))
                  for i in range(n) for a in (1, 2)]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1))


def _grad_band(got, want, what):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=2e-3 * scale,
                               err_msg=what)


# ---------------------------------------------------------------------------
# The specs
# ---------------------------------------------------------------------------

def _port_key(path, shape) -> str:
    """The port's state-dict name of the JAX U-Net parameter at `path`."""
    tree = node = {}
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = np.zeros(shape, np.float32)
    (key,) = tweights.unet_state_dict({"params": tree})
    return key


def _port_dim(jax_dim: int, ndim: int) -> int:
    """A JAX kernel dim in the port's layout (HWIO -> OIHW, [I, O] ->
    [O, I])."""
    return {4: (2, 3, 1, 0), 2: (1, 0)}[ndim][jax_dim]


def test_specs_match_jax_param_spec():
    """Every tiny U-Net tensor JAX param_spec shards (divisibly at
    model_parallel 2) the port shards on the matching dim of its
    state-dict tensor, and no other weight; param_spec itself agrees on
    every weight; a sharded bias belongs to a column-parallel layer."""
    cfg = junet.tiny_unet_config()
    x = np.zeros((1, 8, 8, 5), np.float32)
    shapes = flatten_dict(jax.eval_shape(
        junet.UNet2DCondition(cfg).init, jax.random.PRNGKey(0), x,
        np.zeros((1,), np.int32),
        np.zeros((1, 77, 32), np.float32))["params"])
    mesh = jmake_mesh(4, model_parallel=2)
    with torch.device("meta"):
        state = tunet.UNet2DConditionModel(tunet.tiny_unet_config()
                                           ).state_dict()
    dims = tsharding.sharded_dims(state, 2, tunet.tiny_unet_config())
    specs = tsharding.unet_param_spec(state)
    assert tsharding.replicated_attentions(tunet.tiny_unet_config(), 2) == []
    want = {}
    for path, value in shapes.items():
        key = _port_key(path, value.shape)
        spec = jsharding.param_spec(path, value)
        jdim = spec.index("model") if "model" in spec else None
        port_dim = None if jdim is None else _port_dim(jdim, value.ndim)
        want_spec = () if port_dim is None else tuple(
            "model" if d == port_dim else None
            for d in range(state[key].dim()))
        assert specs[key] == want_spec, (key, spec, specs[key])
        if jdim is not None and jsharding._divisible(value.shape, spec,
                                                     mesh):
            want[key] = port_dim
    got = {k: d for k, d in dims.items() if d is not None
           and k.endswith("weight")}
    assert got == want and len(got) > 40
    for k, d in dims.items():
        if k.endswith("bias") and d is not None:
            assert dims[k[:-4] + "weight"] == 0 == d


def test_sd2_full_shape_specs():
    """The spec half of JAX's slow test_tp_full_shape_sd2_step, on the
    full SD-2 U-Net on the meta device (no compute): more than 100 tensors
    sharded at model_parallel 2, each divisible; the heads deviation is
    exactly the ten 5-head attentions, whose projections param_spec would
    shard; a rank holds about half the bytes."""
    cfg = tunet.UNetConfig()
    with torch.device("meta"):
        state = tunet.UNet2DConditionModel(cfg).state_dict()
    dims = tsharding.sharded_dims(state, 2, cfg)
    sharded = {k: d for k, d in dims.items() if d is not None}
    assert len(sharded) > 100
    for k, d in sharded.items():
        n = state[k].shape[d] // (2 if "ff.net.0.proj" in k else 1)
        assert n % 2 == 0, (k, state[k].shape, d)
    assert tsharding.replicated_attentions(cfg, 2) == SD2_REPLICATED
    for a in SD2_REPLICATED:
        for lin in ("to_q", "to_k", "to_v", "to_out.0"):
            key = f"{a}.{lin}.weight"
            assert dims[key] is None and tsharding.param_spec(
                key, state[key]) != ()
    total = sum(t.numel() for t in state.values())
    local = sum(t.numel() // (2 if dims[k] is not None else 1)
                for k, t in state.items())
    assert 0.5 < local / total < 0.52, local / total


def test_make_mesh_refuses_as_jax():
    """make_mesh raises with the JAX package's messages, before it joins
    anything."""
    with pytest.raises(ValueError, match="Requested 2 devices, have 1"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        make_mesh(1, model_parallel=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1)


# ---------------------------------------------------------------------------
# Four ranks: the TP U-Net and edit_batch on a (2, 2) mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The rig; JAX's tiny U-Net forward + latents gradient and its
    edit_batch on make_mesh(4, model_parallel=2); then the port's four
    ranks (worker run_rank) on the rig's weights, each one's results."""
    jh, th, s, rec = make_rig(num_timesteps=4, guidance_max_step=2)
    rng = np.random.RandomState(2)
    cfg = th.diffuser.models.unet_config
    x = rng.randn(2, 8, 8, cfg.in_channels).astype(np.float32)
    ctx = rng.randn(2, 77, cfg.cross_attention_dim).astype(np.float32)
    t = 17
    with torch.no_grad():
        shapes = [a.shape for a in th.diffuser.models.unet(
            torch.from_numpy(_nchw(x)), torch.tensor(t),
            torch.from_numpy(ctx))[1]]
    weights = [rng.randn(*sh).astype(np.float32) for sh in shapes]
    edit_args = (s["depth"], PROMPT, s["fg_mask"], s["bg_depth"],
                 rec["null_text_emb"], rec["init_noise"], rec["activations"])

    tmp = tmp_path_factory.mktemp("ranks")
    m = th.diffuser.models
    torch.save(dict(config=tconfig.config_to_dict(th.conf),
                    unet=m.unet.state_dict(), vae=m.vae.state_dict(),
                    text=m.text_encoder.state_dict(),
                    x=torch.from_numpy(_nchw(x)), t=torch.tensor(t),
                    ctx=torch.from_numpy(ctx),
                    weights=[torch.from_numpy(w) for w in weights],
                    edit_args=edit_args, transforms=TRANSFORMS),
               tmp / "payload.pt")
    ju = jh.diffuser.models

    def energy(xj, p, cj, wj):
        eps, acts, _ = ju.unet.apply(p, xj, jnp.int32(t), cj)
        e = jnp.sum(eps ** 2) + sum(jnp.sum(jnp.moveaxis(a, -1, 1) * w)
                                    for a, w in zip(acts, wj))
        return e, (eps, acts)

    (_, (eps_j, acts_j)), grad_j = jax.jit(jax.value_and_grad(
        energy, has_aux=True))(x, ju.unet_params, ctx, weights)
    images_j = jedit_batch(jh, *edit_args, TRANSFORMS,
                           mesh=jmake_mesh(4, model_parallel=2))
    with pytest.raises(ValueError, match="divisible by 2"):
        jedit_batch(jh, *edit_args, TRANSFORMS[:3],
                    mesh=jmake_mesh(4, model_parallel=2))
    mp.spawn(run_rank, args=(4, _free_port(), str(tmp / "payload.pt"),
                             str(tmp)), nprocs=4)
    return dict(eps=_nchw(eps_j), acts=[_nchw(a) for a in acts_j],
                grad=_nchw(grad_j), images=images_j,
                ranks=[torch.load(tmp / f"rank{r}.pt", weights_only=False)
                       for r in range(4)])


def test_ranks_join_a_2x2_mesh(four_ranks):
    """Rank r joined a world of 4 and sits at (data, model) = divmod(r,
    2), as JAX's make_mesh lays its devices."""
    for r, out in enumerate(four_ranks["ranks"]):
        assert out["info"] == dict(process_id=r, num_processes=4,
                                   local_devices=1, global_devices=4)
        assert out["coords"] == divmod(r, 2)


def test_tp_forward_matches_replicated_and_jax(four_ranks):
    """The U-Net sharded over the model axis: eps and the three
    activations against the replicated port and against JAX, in the
    forward band."""
    for out in four_ranks["ranks"]:
        eps, acts, _ = out["tp"]
        eps_r, acts_r, _ = out["replicated"]
        for got, rep, want, what in zip(
                [eps, *acts], [eps_r, *acts_r],
                [four_ranks["eps"], *four_ranks["acts"]],
                ["eps", "acts 0", "acts 1", "acts 2"]):
            np.testing.assert_allclose(got.numpy(), rep.numpy(),
                                       err_msg=what, **FWD_BAND)
            np.testing.assert_allclose(got.numpy(), want, err_msg=what,
                                       **FWD_BAND)


def test_tp_latents_grad_matches_replicated_and_jax(four_ranks):
    """The latents' gradient through the sharded U-Net (the backward
    all-reduces of the copies into the model region make it whole)
    against the replicated port and against JAX, in the gradient band."""
    for out in four_ranks["ranks"]:
        grad = out["tp"][2].numpy()
        _grad_band(grad, out["replicated"][2].numpy(), "vs replicated")
        _grad_band(grad, four_ranks["grad"], "vs JAX")
    assert np.abs(four_ranks["grad"]).max() > 0


def test_tp_rank_holds_about_half_the_parameters(four_ranks):
    for out in four_ranks["ranks"]:
        local, full = out["param_bytes"]
        assert 0.5 < local / full < 0.55, local / full


def test_mesh_edit_batch_matches_jax(four_ranks):
    """edit_batch on the (2, 2) mesh: every rank returns all four images,
    the same bits on every rank, each row against JAX edit_batch on
    make_mesh(4, model_parallel=2) in the gradient band."""
    imgs = [out["images"] for out in four_ranks["ranks"]]
    assert imgs[0].shape == four_ranks["images"].shape == (4, 3, 32, 32)
    for other in imgs[1:]:
        np.testing.assert_array_equal(other, imgs[0])
    for i in range(4):
        _grad_band(imgs[0][i], four_ranks["images"][i], f"row {i}")


def test_twin_rows_on_two_data_ranks_are_bitwise(four_ranks):
    """Rows 0 and 2 (the same transform) run on data ranks 0 and 1."""
    imgs = four_ranks["ranks"][0]["images"]
    np.testing.assert_array_equal(imgs[0], imgs[2])
    assert not np.array_equal(imgs[0], imgs[1])


def test_uneven_batch_raises_as_jax(four_ranks):
    """Three transforms on a data axis of 2: JAX's jit with P('data')
    refuses them (checked in the fixture), and so does every rank."""
    for out in four_ranks["ranks"]:
        assert "'data' axis of size 2 does not divide a batch of 3" in \
            out["uneven"]


# ---------------------------------------------------------------------------
# The env contract
# ---------------------------------------------------------------------------

_WORKER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from diffusionhandles_tpu_torch.parallel.distributed import \
    maybe_init_from_env
info = maybe_init_from_env(device="cpu")
assert info is not None and info["num_processes"] == 2, info
parts = [torch.zeros(1) for _ in range(2)]
dist.all_gather(parts, torch.tensor([info["process_id"] + 1.0]))
total = float(sum(parts))
assert total == 3.0, total
print(f"OK process={info['process_id']} global_devices="
      f"{info['global_devices']} total={total}", flush=True)
dist.destroy_process_group()
"""


def test_two_process_env_contract_join():
    """tests/test_distributed.py's worker on the port: two processes join
    under DIFFHANDLES_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID (gloo on
    the CPU) and all-gather (process_id + 1), summing to 3."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, DIFFHANDLES_COORDINATOR=f"localhost:{port}",
                   DIFFHANDLES_NUM_PROCESSES="2",
                   DIFFHANDLES_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, ROOT], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"OK process={pid} global_devices=2 total=3.0" in out, out
