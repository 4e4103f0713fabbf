"""The test-set path on the CPU, PyTorch port vs the JAX package: the
driver end to end on tiny handles (precomputed depths, then the tiny
ZoeDepth and LaMa estimators), the identity cache read back by both
packages, and `create_sd_models` loading a diffusers `checkpoint_dir`.

The driver runs on the small-weights rig (tests/torch_port_rig.py: both
facades on the same weights) at 3 timesteps. The JAX driver reads the
identity npz the port's wrote and reconstructs from it, so the two
recon PSNR/SSIM figures describe the same latent decoded by each package's
VAE: they agree to the rounding the driver applies (3 decimals of dB, 4
of SSIM) within RECON_PSNR_DB and RECON_SSIM.
"""

import dataclasses
import json
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffusionhandles_tpu.models import lama as jlama
from diffusionhandles_tpu.models import zoedepth as jzoe
from diffusionhandles_tpu.models.weights import load_sd_checkpoint
from diffusionhandles_tpu.testset import driver as jdriver
from diffusionhandles_tpu_torch.config import (GuidedDiffuserConfig,
                                               ModelPathsConfig)
from diffusionhandles_tpu_torch.diffuser import create_sd_models
from diffusionhandles_tpu_torch.models import lama as tlama
from diffusionhandles_tpu_torch.models import tokenizer as ttok
from diffusionhandles_tpu_torch.models import weights as tweights
from diffusionhandles_tpu_torch.models import zoedepth as tzoe
from diffusionhandles_tpu_torch.models.weights_lama import lama_state_dict
from diffusionhandles_tpu_torch.models.weights_zoedepth import \
    zoedepth_state_dict
from diffusionhandles_tpu_torch.pipeline import DiffusionHandles
from diffusionhandles_tpu_torch.testset import driver as tdriver
from diffusionhandles_tpu_torch.utils.image_io import (read_png, save_depth,
                                                       save_image)
from torch_port_rig import torch_on_one_thread  # noqa: F401
from torch_port_rig import make_rig

RECON_PSNR_DB = 0.01
RECON_SSIM = 1e-3
TRANSFORMS = {
    "edit_000": {"translation": [0.1, 0.0, 0.0],
                 "rotation_axis": [0.0, 1.0, 0.0], "rotation_angle": 0.0},
    "edit_001": {"translation": [0.0, 0.0, 0.0],
                 "rotation_axis": [0.0, 1.0, 0.0], "rotation_angle": 15.0},
}


def _make_sample(d: pathlib.Path, res: int, depths: bool = True):
    """The JAX driver test's synthetic sample (tests/test_testset.py),
    written with the port's image_io; without `depths`, no depth.exr and
    bg_depth.exr, so the estimators must run."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    save_image(rng.rand(3, res, res).astype(np.float32), d / "input.png")
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    fg = ((yy >= res // 3) & (yy < 2 * res // 3)
          & (xx >= res // 3) & (xx < 2 * res // 3))
    save_image(np.repeat(fg[None].astype(np.float32), 3, 0), d / "mask.png")
    if depths:
        depth = (2.0 + 0.002 * yy).astype(np.float32)
        depth_fg = depth.copy()
        depth_fg[fg] -= 0.4
        save_depth(depth_fg[None], d / "depth.exr")
        save_depth(depth[None], d / "bg_depth.exr")
    (d / "prompt.txt").write_text("a toy cube on a table\n")
    (d / "transforms.json").write_text(json.dumps(TRANSFORMS))


def _manifest(path: pathlib.Path, entries: dict) -> pathlib.Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(entries))
    return path


@pytest.fixture(scope="module")
def rig():
    return make_rig(num_timesteps=3, guidance_max_step=2, num_optsteps=1)


@pytest.fixture(scope="module")
def run(rig, tmp_path_factory):
    """The port's driver over one sample with two transforms, the identity
    cached, with the temporary directory (where the cache lives) inside
    this module's own."""
    _, th, _, _ = rig
    root = tmp_path_factory.mktemp("testset")
    (root / "tmp").mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tempfile, "tempdir", str(root / "tmp"))
        _make_sample(root / "inputs" / "cube", th.img_res)
        manifest = _manifest(root / "set.json",
                             {"cube": ["edit_000", "edit_001"]})
        tdriver.test_diffusion_handles(
            test_set_path=str(manifest), input_dir=str(root / "inputs"),
            output_dir=str(root / "results"), handles=th,
            img_res=th.img_res, cache_input_image_identity=True)
        yield root, manifest


def test_driver_writes_outputs_and_identity(run):
    root, _ = run
    sdir = root / "results" / "cube"
    for fname in ["input.png", "mask.png", "disparity.png", "recon.png",
                  "edit_000.png", "edit_001.png", "edit_000_disparity.png"]:
        assert (sdir / fname).exists(), fname
    html = (root / "results" / "set_summary.html").read_text()
    assert "edit_000.png" in html and "cube" in html
    assert json.loads((root / "results" / "set.json").read_text()) == {
        "cube": ["edit_000", "edit_001"]}
    metrics = json.loads((root / "results" / "metrics.json").read_text())
    sample = metrics["samples"]["cube"]
    assert set(sample["transforms"]) == {"edit_000", "edit_001"}
    assert set(sample["seconds"]) == {"preprocess", "invert", "edits", "io"}
    ident = root / "tmp" / "diffhandles" / "set" / "cube" / \
        "input_image_identity.npz"
    with np.load(ident) as data:
        assert set(data.files) == {"null_text_emb", "init_noise",
                                   "activations1", "activations2",
                                   "activations3", "latent_image"}


def test_driver_cached_rerun_is_bitwise(run, rig):
    """A second run reads the identity from the cache: the same images,
    bit for bit, and the same metrics."""
    root, manifest = run
    _, th, _, _ = rig
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tempfile, "tempdir", str(root / "tmp"))
        mp.setattr(th, "invert_input_image", None)  # must not be called
        tdriver.test_diffusion_handles(
            test_set_path=str(manifest), input_dir=str(root / "inputs"),
            output_dir=str(root / "rerun"), handles=th, img_res=th.img_res,
            cache_input_image_identity=True, generate_webpage=False)
    for fname in ["recon.png", "edit_000.png", "edit_001.png",
                  "edit_001_disparity.png"]:
        np.testing.assert_array_equal(
            read_png(root / "rerun" / "cube" / fname),
            read_png(root / "results" / "cube" / fname), err_msg=fname)
    first = json.loads((root / "results" / "metrics.json").read_text())
    again = json.loads((root / "rerun" / "metrics.json").read_text())
    for m in (first, again):
        del m["samples"]["cube"]["seconds"]
    assert again == first


def test_driver_recon_and_config_match_jax(run, rig):
    """The JAX driver on the same sample, its identity read from the npz
    the port wrote (no transforms, so no edit runs): the same recon
    PSNR/SSIM, and config.yaml files that load to equal mappings."""
    root, _ = run
    jh, _, _, _ = rig
    manifest = _manifest(root / "set_jax" / "set.json", {"cube": []})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tempfile, "tempdir", str(root / "tmp"))
        jdriver.test_diffusion_handles(
            test_set_path=str(manifest), input_dir=str(root / "inputs"),
            output_dir=str(root / "jax"), handles=jh, img_res=jh.img_res,
            cache_input_image_identity=True, generate_webpage=False)
    port = json.loads((root / "results" / "metrics.json").read_text())
    jax_ = json.loads((root / "jax" / "metrics.json").read_text())
    p, j = port["samples"]["cube"], jax_["samples"]["cube"]
    assert abs(p["recon_psnr_db"] - j["recon_psnr_db"]) <= RECON_PSNR_DB
    assert abs(p["recon_ssim"] - j["recon_ssim"]) <= RECON_SSIM
    with open(root / "results" / "config.yaml") as f:
        port_conf = yaml.safe_load(f)
    with open(root / "jax" / "config.yaml") as f:
        assert yaml.safe_load(f) == port_conf


def test_driver_skip_existing_merges_metrics(run, rig):
    """--skip_existing skips a finished sample and runs a new one; the
    metrics keep both, the finished sample's unchanged."""
    root, manifest = run
    _, th, _, _ = rig
    before = json.loads((root / "results" / "metrics.json").read_text())
    _make_sample(root / "inputs" / "cube2", th.img_res)
    _manifest(manifest, {"cube": ["edit_000", "edit_001"],
                         "cube2": ["edit_000"]})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tempfile, "tempdir", str(root / "tmp"))
        tdriver.test_diffusion_handles(
            test_set_path=str(manifest), input_dir=str(root / "inputs"),
            output_dir=str(root / "results"), handles=th,
            img_res=th.img_res, skip_existing=True, generate_webpage=False)
    merged = json.loads((root / "results" / "metrics.json").read_text())
    assert set(merged["samples"]) == {"cube", "cube2"}
    assert merged["num_samples"] == 2
    assert merged["samples"]["cube"] == before["samples"]["cube"]


def _estimators():
    """Tiny ZoeDepth and LaMa in both packages on the same weights."""
    rng = np.random.RandomState(0)
    perturb = lambda tree: jax.tree.map(lambda a: np.asarray(a) + (
        rng.randn(*a.shape) * 0.02).astype(np.float32), tree)
    zcfg = jzoe.tiny_zoedepth_config()
    zp = perturb(jax.jit(jzoe.ZoeDepthModel(zcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32)))
    lcfg = jlama.tiny_lama_config()
    lv = jax.jit(jlama.LamaGenerator(lcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 4), jnp.float32))
    lv = {"params": perturb(lv["params"]), "batch_stats": lv["batch_stats"]}
    return ((jzoe.ZoeDepthEstimator(zcfg, params=zp),
             jlama.LamaInpainter(lcfg, params=lv)),
            (tzoe.ZoeDepthEstimator(tzoe.tiny_zoedepth_config(),
                                    params=zoedepth_state_dict(zp),
                                    device="cpu"),
             tlama.LamaInpainter(tlama.tiny_lama_config(),
                                 params=lama_state_dict(
                                     lv, tlama.tiny_lama_config()),
                                 device="cpu")))


def test_driver_with_estimators(rig, tmp_path):
    """No depth files: both packages' load_diffhandles_inputs make the
    depth, the background (LaMa) and its depth with their estimators on
    the same weights, within the estimators' parity tolerances; the port's
    driver then runs the batched edit on them."""
    _, th, _, _ = rig
    (jz, jl), (tz, tl) = _estimators()
    _make_sample(tmp_path / "inputs" / "cube", th.img_res, depths=False)
    want = jdriver.load_diffhandles_inputs(tmp_path / "inputs", "cube",
                                           th.img_res, jz, jl)
    got = tdriver.load_diffhandles_inputs(tmp_path / "inputs", "cube",
                                          th.img_res, tz, tl)
    assert got[:2] == want[:2]
    for a, b in zip(got[2:4], want[2:4]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[4:], want[4:]):  # depth, bg depth
        assert a.shape == b.shape == (1, 1, th.img_res, th.img_res)
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    manifest = _manifest(tmp_path / "set.json", {"cube": ["edit_001",
                                                          "edit_000"]})
    tdriver.test_diffusion_handles(
        test_set_path=str(manifest), input_dir=str(tmp_path / "inputs"),
        output_dir=str(tmp_path / "results"), handles=th,
        img_res=th.img_res, depth_estimator=tz, foreground_remover=tl,
        batched=True, batch_chunk=2, generate_webpage=False)
    for fname in ["edit_000.png", "edit_001.png", "edit_001_disparity.png"]:
        assert (tmp_path / "results" / "cube" / fname).exists(), fname


# ---------------------------------------------------------------------------
# create_sd_models(checkpoint_dir=...)
# ---------------------------------------------------------------------------

def _write_vocab(tok_dir: pathlib.Path):
    """A small CLIP BPE vocabulary (as tests/test_torch_port_basics.py)."""
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, "!": 2}
    for ch in "abcdefghijklmnopqrstuvwxyz":
        vocab[ch] = len(vocab)
    for piece in ["a</w>", "t</w>", "at</w>", "c", "ca", "cat</w>"]:
        vocab[piece] = len(vocab)
    tok_dir.mkdir(parents=True)
    (tok_dir / "vocab.json").write_text(json.dumps(vocab))
    (tok_dir / "merges.txt").write_text("#version: 0.2\na t</w>\nc a\n"
                                        "ca t</w>")


def test_checkpoint_dir_loads_strictly(tmp_path):
    """Seeded tiny weights written in the diffusers layout (unet and
    text_encoder as safetensors, vae as .bin, a text encoder holding the
    position_ids buffer, a small vocabulary) load back bitwise without the
    safetensors package, and the JAX package's loader reads the same
    directory to the same parameters; the loaded stack's edit equals the
    seeded one's; a wrong shape fails loudly."""
    from safetensors.torch import save_file
    conf = GuidedDiffuserConfig(num_timesteps=3, guidance_max_step=2,
                                num_optsteps=1, dtype="float32",
                                activation_store_dtype="float32")
    seeded = create_sd_models(conf=conf, variant="tiny", device="cpu")
    sds = {name: {k: v.contiguous() for k, v in getattr(
        seeded, attr).state_dict().items()}
        for name, attr in (("unet", "unet"), ("vae", "vae"),
                           ("text_encoder", "text_encoder"))}
    for name in sds:
        (tmp_path / name).mkdir()
    save_file(sds["unet"], str(tmp_path / "unet"
                               / "diffusion_pytorch_model.safetensors"))
    torch.save(sds["vae"], tmp_path / "vae" / "diffusion_pytorch_model.bin")
    save_file({**sds["text_encoder"],
               "text_model.embeddings.position_ids":
                   torch.arange(77).reshape(1, 77)},
              str(tmp_path / "text_encoder" / "model.safetensors"))
    _write_vocab(tmp_path / "tokenizer")

    paths = ModelPathsConfig(checkpoint_dir=str(tmp_path))
    loaded = create_sd_models(paths, conf, variant="tiny", device="cpu")
    for name, attr in (("unet", "unet"), ("vae", "vae"),
                       ("text_encoder", "text_encoder")):
        got = getattr(loaded, attr).state_dict()
        assert set(got) == set(sds[name])
        for k, v in sds[name].items():
            assert torch.equal(got[k], v), (name, k)
    assert isinstance(loaded.tokenizer, ttok.CLIPBPETokenizer)

    unet_p, vae_p, text_p = load_sd_checkpoint(str(tmp_path))
    for sd, back in ((sds["unet"], tweights.unet_state_dict(unet_p)),
                     (sds["vae"], tweights.vae_state_dict(vae_p)),
                     (sds["text_encoder"], tweights.clip_state_dict(text_p))):
        assert set(back) == set(sd)
        for k in sd:
            assert torch.equal(back[k], sd[k]), k

    from diffusionhandles_tpu_torch.config import DiffusionHandlesConfig
    edits = []
    for models in (seeded, dataclasses.replace(
            loaded, tokenizer=seeded.tokenizer)):
        h = DiffusionHandles(DiffusionHandlesConfig(guided_diffuser=conf),
                             variant="tiny", device="cpu", models=models)
        res = h.img_res
        yy = np.arange(res, dtype=np.float32)[:, None].repeat(res, 1)
        depth = (2.0 + 0.01 * yy)[None, None]
        fg = np.zeros((1, 1, res, res), np.float32)
        fg[..., res // 3:2 * res // 3, res // 3:2 * res // 3] = 1.0
        null, noise, acts, _ = h.generate_input_image(depth, "a cat")
        edits.append(h.transform_foreground(
            depth=depth - 0.4 * fg, prompt="a cat", fg_mask=fg,
            bg_depth=depth, null_text_emb=null, init_noise=noise,
            activations=acts, rot_angle=10.0)[0])
    np.testing.assert_array_equal(edits[0], edits[1])

    bad = dict(sds["unet"])
    bad["conv_in.weight"] = bad["conv_in.weight"][:, :, :2].contiguous()
    save_file(bad, str(tmp_path / "unet"
                       / "diffusion_pytorch_model.safetensors"))
    with pytest.raises(ValueError, match="unet checkpoint"):
        create_sd_models(paths, conf, variant="tiny", device="cpu")


@pytest.mark.parametrize("shape", [(3, 48, 40), (40, 37), (32, 32, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_metrics_match_jax(shape):
    """PSNR and SSIM (the separable Gaussian window) against the JAX
    package's, in the layouts it takes."""
    from diffusionhandles_tpu.testset import metrics as jmetrics
    from diffusionhandles_tpu_torch.testset import metrics as tmetrics
    rng = np.random.RandomState(len(shape))
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    assert tmetrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert tmetrics.psnr(a, a) == float("inf")
    np.testing.assert_allclose(tmetrics.ssim(a, b), jmetrics.ssim(a, b),
                               rtol=1e-12, atol=0)
