"""PyTorch port vs the JAX package: config, tokenizers, seeded noise and
the DDIM scheduler. All exact in fp32. Also the port's guards: entry
points run on the GPU unless asked, and nothing of the port imports JAX."""

import ast
import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionhandles_tpu import config as jconfig
from diffusionhandles_tpu import scheduler as jsched
from diffusionhandles_tpu.models import tokenizer as jtok
from diffusionhandles_tpu.utils.rng import seeded_randn as j_randn
from diffusionhandles_tpu_torch import config as tconfig
from diffusionhandles_tpu_torch import scheduler as tsched
from diffusionhandles_tpu_torch.models import tokenizer as ttok
from diffusionhandles_tpu_torch.utils.rng import seeded_randn as t_randn


def test_config_fields_and_defaults_match():
    for jcls, tcls in [(jconfig.GuidedDiffuserConfig,
                        tconfig.GuidedDiffuserConfig),
                       (jconfig.ModelPathsConfig, tconfig.ModelPathsConfig)]:
        assert dataclasses.asdict(jcls()) == dataclasses.asdict(tcls())
    j = jconfig.config_to_dict(jconfig.DiffusionHandlesConfig())
    t = tconfig.config_to_dict(tconfig.DiffusionHandlesConfig())
    assert j == t


def test_load_config_yaml_overlay(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("guided_diffuser:\n  num_timesteps: 7\n  fg_weight: 2.0\n"
                    "depth_transform_mode: pc\n")
    t = tconfig.load_config(str(path))
    j = jconfig.load_config(str(path))
    assert tconfig.config_to_dict(t) == jconfig.config_to_dict(j)
    assert t.guided_diffuser.num_timesteps == 7
    with pytest.raises(KeyError):
        tconfig.config_from_dict({"guided_diffuser": {"nope": 1}})


def test_hash_tokenizer_matches():
    prompts = ["a toy cube on a table", "", "  Two   WORDS "]
    for vocab in (1024, 49408):
        assert (ttok.HashTokenizer(vocab_size=vocab)(prompts)
                == jtok.HashTokenizer(vocab_size=vocab)(prompts))


def test_bpe_tokenizer_matches(tmp_path):
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, "!": 2}
    for ch in "abcdefghijklmnopqrstuvwxyz":
        vocab[ch] = len(vocab)
    for piece in ["a</w>", "t</w>", "at</w>", "c", "ca", "cat</w>", "ta",
                  "hat</w>", "h", "ha"]:
        vocab[piece] = len(vocab)
    merges = ["a t</w>", "c a", "ca t</w>", "h a", "ha t</w>", "t a"]
    (tmp_path / "tokenizer").mkdir()
    (tmp_path / "tokenizer" / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "tokenizer" / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(merges))
    t = ttok.load_tokenizer(str(tmp_path), max_length=8)
    j = jtok.load_tokenizer(str(tmp_path), max_length=8)
    assert isinstance(t, ttok.CLIPBPETokenizer)
    for text in ["cat hat", "a cat", "cat " * 50, " CAT "]:
        assert t([text]) == j([text])


def test_seeded_randn_bitwise():
    shape = (1, 4, 64, 64)
    got = t_randn(shape, 2773)
    want = j_randn(shape, 2773)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        t_randn(shape, 0, method="jax")


@pytest.mark.parametrize("steps", [6, 50])
def test_schedule_tables_exact(steps):
    t = tsched.make_ddim_schedule(steps)
    j = jsched.make_ddim_schedule(steps)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    for name in ("alphas_cumprod", "alpha_t", "alpha_prev"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.final_alpha_cumprod == j.final_alpha_cumprod


def test_step_functions_exact_fp32():
    steps = 50
    t = tsched.make_ddim_schedule(steps)
    j = jsched.make_ddim_schedule(steps)
    rng = np.random.RandomState(0)
    sample = rng.randn(1, 4, 8, 8).astype(np.float32)
    eps = rng.randn(1, 4, 8, 8).astype(np.float32)
    for s in (0, 17, steps - 1):
        for tf, jf in [(tsched.ddim_step, jsched.ddim_step),
                       (tsched.ddim_next_step, jsched.ddim_next_step)]:
            got = tf(t, torch.from_numpy(eps), s, torch.from_numpy(sample))
            want = jf(j, jnp.asarray(eps), s, jnp.asarray(sample))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-7, atol=2e-7)
    got = tsched.add_noise(t, torch.from_numpy(sample), torch.from_numpy(eps),
                           int(t.timesteps[0]))
    want = jsched.add_noise(j, jnp.asarray(sample), jnp.asarray(eps),
                            int(j.timesteps[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7,
                               atol=2e-7)


# ---------------------------------------------------------------------------
# Where the port's entry points run: the GPU unless the caller asks
# ---------------------------------------------------------------------------

def _entry_points():
    from diffusionhandles_tpu_torch import diffuser as tdiffuser
    from diffusionhandles_tpu_torch import guidance as tguidance
    from diffusionhandles_tpu_torch import pipeline as tpipeline
    from diffusionhandles_tpu_torch.geometry import mesh_transform as tmt
    from diffusionhandles_tpu_torch.geometry import transform as ttrans
    from diffusionhandles_tpu_torch.models import lpips as tlpips
    from diffusionhandles_tpu_torch.service import \
        pipeline_app as tpipeline_app
    depth = np.full((1, 1, 16, 16), 2.0, np.float32)
    fg = np.zeros_like(depth)
    fg[..., 5:10, 5:10] = 1.0
    return {
        "DiffusionHandles": lambda **kw: tpipeline.DiffusionHandles(
            variant="tiny", **kw),
        "GuidedStableDiffuser": lambda **kw: tdiffuser.GuidedStableDiffuser(
            tconfig.GuidedDiffuserConfig(), variant="tiny", **kw),
        "create_sd_models": lambda **kw: tdiffuser.create_sd_models(
            variant="tiny", **kw),
        "transform_depth_pc_processed":
            lambda **kw: ttrans.transform_depth_pc_processed(
                depth, depth, np.zeros_like(depth), np.eye(3), max_corr=16,
                latent_res=8, **kw),
        "transform_depth": lambda **kw: ttrans.transform_depth(
            depth, depth, fg, np.eye(3), rot_angle=5.0, **kw),
        "process_correspondences":
            lambda **kw: tguidance.process_correspondences(
                np.array([[1, 2, 3, 4]]), img_res=16, max_corr=16,
                latent_res=8, **kw),
        "transform_depth_mesh": lambda **kw: tmt.transform_depth_mesh(
            depth, depth, fg, np.eye(3), rot_angle=5.0, **kw),
        "DiffhandlesPipeline": lambda **kw: tpipeline_app.DiffhandlesPipeline(
            **kw),
        "LPIPSMetric": lambda **kw: tlpips.LPIPSMetric(**kw),
    }


@pytest.mark.parametrize("name", ["DiffusionHandles", "GuidedStableDiffuser",
                                  "create_sd_models",
                                  "transform_depth_pc_processed",
                                  "transform_depth", "process_correspondences",
                                  "transform_depth_mesh",
                                  "DiffhandlesPipeline", "LPIPSMetric"])
def test_entry_points_without_device_raise_without_cuda(name, monkeypatch):
    """With no device and no CUDA, an entry point raises instead of running
    on the CPU; with device="cpu" it runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    entry = _entry_points()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    assert entry(device="cpu") is not None


def test_default_device_is_cuda(monkeypatch):
    from diffusionhandles_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# The port imports nothing of JAX
# ---------------------------------------------------------------------------

ROOT = pathlib.Path(__file__).parents[1]
FORBIDDEN = ("jax", "flax", "diffusionhandles_tpu", "aiohttp")
# packages the GPU machine does not have: a function may import one (and
# is then not called there), a module may not
NOT_AT_MODULE_LEVEL = ("cv2", "imageio", "PIL", "yaml", "safetensors")


def _matches(module: str, packages) -> bool:
    return any(module == f or module.startswith(f + ".") for f in packages)


def _forbidden(module: str) -> bool:
    return _matches(module, FORBIDDEN)


def _import_names(node):
    if isinstance(node, ast.Import):
        yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        yield node.module


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        yield from _import_names(node)


def _module_level_imports(tree: ast.AST):
    """Imports run when the module is imported: anywhere but inside a
    function body."""
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield from _import_names(node)
        stack.extend(ast.iter_child_nodes(node))


def _port_sources():
    files = sorted((ROOT / "diffusionhandles_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_forbidden_import_check_catches_imports():
    src = ("import jax.numpy as jnp\nfrom flax import linen\n"
           "from diffusionhandles_tpu.ops import conv\n"
           "import diffusionhandles_tpu_torch.ops\n"
           "def serve():\n    from aiohttp import web\n")
    found = [m for m in _imports(ast.parse(src)) if _forbidden(m)]
    assert found == ["jax.numpy", "flax", "diffusionhandles_tpu.ops",
                     "aiohttp"]


def test_module_level_import_check_catches_imports():
    src = ("import cv2\nimport numpy\ntry:\n    import yaml\n"
           "except ImportError:\n    pass\n"
           "class A:\n    from PIL import Image\n"
           "def f():\n    import imageio.v3\n    import safetensors\n")
    found = [m for m in _module_level_imports(ast.parse(src))
             if _matches(m, NOT_AT_MODULE_LEVEL)]
    assert sorted(found) == ["PIL", "cv2", "yaml"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """No module of the port, and no line of chip_smoke.py, imports jax,
    flax, the JAX package or aiohttp (the exact module or a submodule;
    the port's own diffusionhandles_tpu_torch is not one; the services
    serve on the standard library), and none imports cv2,
    imageio, PIL, yaml or safetensors when it is imported (the GPU
    machine has none of them)."""
    tree = ast.parse(path.read_text())
    bad = [m for m in _imports(tree) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    bad = [m for m in _module_level_imports(tree)
           if _matches(m, NOT_AT_MODULE_LEVEL)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} at load"


# ---------------------------------------------------------------------------
# The port's public API keeps the JAX package's parameters
# ---------------------------------------------------------------------------

def _public_functions(tree: ast.Module) -> dict:
    """name -> parameter names of the module's public functions and of
    the public methods (and __init__) of its public classes."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith(
                "_"):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef) and not node.name.startswith(
                "_"):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and (
                        sub.name == "__init__"
                        or not sub.name.startswith("_")):
                    out[f"{node.name}.{sub.name}"] = sub
    return {name: [a.arg for a in fn.args.posonlyargs + fn.args.args
                   + fn.args.kwonlyargs] for name, fn in out.items()}


def _shared_functions():
    jax_root = ROOT / "diffusionhandles_tpu"
    for jpath in sorted(jax_root.rglob("*.py")):
        rel = jpath.relative_to(jax_root)
        tpath = ROOT / "diffusionhandles_tpu_torch" / rel
        if not tpath.exists():
            continue
        jfns = _public_functions(ast.parse(jpath.read_text()))
        tfns = _public_functions(ast.parse(tpath.read_text()))
        for name in sorted(set(jfns) & set(tfns)):
            yield f"{rel}:{name}", jfns[name], tfns[name]


def test_shared_functions_keep_jax_parameters():
    """For every public function or method that a module of both packages
    defines, the JAX parameter names are a prefix of the port's (the
    port's own additions, such as `device`, come last), so a call written
    for the JAX package binds the same arguments."""
    shared = list(_shared_functions())
    assert len(shared) > 100  # the comparison finds the shared surface
    bad = [(name, j, t) for name, j, t in shared if t[:len(j)] != j]
    assert not bad, bad


def test_api_members_added_for_the_jax_surface():
    """scheduler.scale_model_input is the identity; the abstract bases
    raise; the diffuser's shapes are NCHW; DiffusionHandles.to moves the
    models; edit_batch and its runner take `mesh` before `chunk` and
    accept one: on a world of one (make_mesh(1)) edit_batch gives the
    mesh=None rows bitwise."""
    from diffusionhandles_tpu_torch.diffuser import (GuidedDiffuser,
                                                     GuidedStableDiffuser)
    from diffusionhandles_tpu_torch.inverter import (NullInverter,
                                                     StableNullInverter)
    from diffusionhandles_tpu_torch.parallel import batch as tbatch
    from diffusionhandles_tpu_torch.pipeline import DiffusionHandles
    x = torch.randn(1, 4, 8, 8)
    assert tsched.scale_model_input(x, 10) is x
    with pytest.raises(NotImplementedError):
        GuidedDiffuser(tconfig.GuidedDiffuserConfig()).encode_latent_image(x)
    with pytest.raises(NotImplementedError):
        NullInverter(None).invert(x, x, "")
    assert issubclass(GuidedStableDiffuser, GuidedDiffuser)
    assert issubclass(StableNullInverter, NullInverter)
    h = DiffusionHandles(variant="tiny", device="cpu")
    d = h.diffuser
    assert d.get_image_shape() == (3, h.img_res, h.img_res)
    assert d.get_feature_shape() == (4, d.latent_res, d.latent_res)
    d.encode_prompt("a cat")
    assert h.to("meta") is h and h.device == torch.device("meta")
    assert d.models.unet.conv_in.weight.device.type == "meta"
    assert not d._prompt_cache
    import torch.distributed as dist

    from diffusionhandles_tpu_torch.parallel.mesh import make_mesh
    from torch_port_rig import one_thread, sample
    conf = tconfig.DiffusionHandlesConfig()
    g = conf.guided_diffuser
    g.num_timesteps, g.guidance_max_step, g.num_optsteps = 2, 1, 1
    g.dtype = g.param_dtype = g.activation_store_dtype = "float32"
    h = DiffusionHandles(conf, variant="tiny", device="cpu")
    s = sample(h.img_res)
    trs = [{"rotation_angle": 10.0, "rotation_axis": [0, 1, 0]},
           {"translation": [0.05, 0.0, 0.0]}]
    with one_thread():  # bitwise reruns on the CPU
        null, noise, acts, _ = h.generate_input_image(s["depth"], "a cube")
        args = (s["depth"], "a cube", s["fg_mask"], s["bg_depth"], null,
                noise, acts, trs)
        want = tbatch.edit_batch(h, *args)
        mesh = make_mesh(1, device="cpu")
        try:
            assert mesh.shape == (1, 1)
            assert mesh.mesh_dim_names == ("data", "model")
            got = tbatch.edit_batch(h, *args, mesh)
            assert callable(tbatch.build_batched_guided_inference(
                h.diffuser, 1, 1, "l2", 1, 1, mesh))
        finally:
            dist.destroy_process_group()
    assert got.shape == (2, 3, h.img_res, h.img_res)
    np.testing.assert_array_equal(got, want)
