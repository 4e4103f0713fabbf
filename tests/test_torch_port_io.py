"""The port's file I/O against the JAX package and the libraries it uses,
on the CPU: PNG (the port's own zlib reader and writer against imageio),
EXR (the port's build of exr_lite against the JAX package's),
`crop_and_resize` (resampling matrices against cv2.INTER_AREA and
INTER_LINEAR, through the JAX function), the identity npz (written by one
package, read by the other) and the safetensors reader (against the
safetensors package)."""

import imageio.v3 as iio
import numpy as np
import pytest
import torch

from diffusionhandles_tpu import checkpoint as jckpt
from diffusionhandles_tpu.utils import exr as jexr
from diffusionhandles_tpu.utils import image_io as jio
from diffusionhandles_tpu_torch import checkpoint as tckpt
from diffusionhandles_tpu_torch.models.weights import load_safetensors
from diffusionhandles_tpu_torch.utils import exr as texr
from diffusionhandles_tpu_torch.utils import image_io as tio

# crop_and_resize: float64 matrices against cv2's float32 resampling, on
# [0, 1] images (the largest gap measured is 1.8e-7)
RESIZE_ATOL = 1e-6


def _natural(h, w, c, seed=0):
    """A smooth image with noise, so that a PNG encoder picks every
    filter type."""
    yy, xx = np.mgrid[:h, :w]
    rng = np.random.RandomState(seed)
    base = np.stack([(xx * (k + 1) + yy * (3 - k)) % 256 for k in range(c)],
                    -1)
    noisy = base + rng.randint(-3, 4, base.shape) * (xx[..., None] % 5 == 0)
    return np.clip(noisy, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_both_ways_with_imageio(tmp_path, channels):
    """The port's PNG writer is read by imageio, and imageio's PNGs (with
    its filters) by the port, with the same bytes of pixels."""
    img = _natural(37, 53, channels)
    if channels == 1:
        img = img[..., 0]
    tio.write_png(tmp_path / "port.png", img)
    np.testing.assert_array_equal(iio.imread(tmp_path / "port.png"), img)
    iio.imwrite(tmp_path / "lib.png", img)
    np.testing.assert_array_equal(tio.read_png(tmp_path / "lib.png"), img)


def test_load_save_image_across_packages(tmp_path):
    """save_image of one package, load_image of the other: the same
    arrays, for RGB and gray."""
    rng = np.random.RandomState(1)
    for c in (3, 1):
        img = rng.rand(c, 24, 20).astype(np.float32)
        tio.save_image(img, tmp_path / f"t{c}.png")
        jio.save_image(img, tmp_path / f"j{c}.png")
        np.testing.assert_array_equal(jio.load_image(tmp_path / f"t{c}.png"),
                                      tio.load_image(tmp_path / f"t{c}.png"))
        np.testing.assert_array_equal(tio.load_image(tmp_path / f"j{c}.png"),
                                      jio.load_image(tmp_path / f"j{c}.png"))
        np.testing.assert_array_equal(tio.load_image(tmp_path / f"t{c}.png"),
                                      jio.load_image(tmp_path / f"j{c}.png"))


@pytest.mark.parametrize("half", [True, False])
def test_exr_across_packages(tmp_path, half):
    """EXR depth and RGB written by one package read back by the other,
    bitwise; save_depth/load_depth the same."""
    rng = np.random.RandomState(2)
    depth = (1.0 + 3.0 * rng.rand(17, 23)).astype(np.float32)
    rgb = rng.rand(9, 11, 3).astype(np.float32)
    for data in (depth, rgb):
        texr.write_exr(str(tmp_path / "t.exr"), data, half=half)
        jexr.write_exr(str(tmp_path / "j.exr"), data, half=half)
        order = ["R", "G", "B"] if data.ndim == 3 else None
        a = texr.read_exr(str(tmp_path / "j.exr"), channel_order=order)
        b = jexr.read_exr(str(tmp_path / "t.exr"), channel_order=order)
        np.testing.assert_array_equal(a, b)
        if not half:
            np.testing.assert_array_equal(a, data)
    tio.save_depth(depth[None], tmp_path / "d.exr")
    np.testing.assert_array_equal(tio.load_depth(tmp_path / "d.exr"),
                                  jio.load_depth(tmp_path / "d.exr"))


@pytest.mark.parametrize("hw", [(1024, 1024), (768, 768), (600, 800),
                                (384, 384), (512, 512)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_crop_and_resize_matches_jax(hw):
    """Center crop, then INTER_AREA down (an integer ratio, 1.5, 1.17)
    or INTER_LINEAR up (384 -> 512) to 512, within RESIZE_ATOL of the JAX
    function's cv2.resize."""
    img = np.random.RandomState(3).rand(3, *hw).astype(np.float32)
    got = tio.crop_and_resize(img, 512)
    want = jio.crop_and_resize(img, 512)
    assert got.shape == want.shape == (3, 512, 512)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)
    mask = (img[:1] > 0.5).astype(np.float32)  # the one-channel mask path
    np.testing.assert_allclose(tio.crop_and_resize(mask, 512),
                               jio.crop_and_resize(mask, 512),
                               atol=RESIZE_ATOL, rtol=0)


def _identity(seed):
    rng = np.random.RandomState(seed)
    return dict(null_text_emb=rng.randn(3, 1, 77, 8).astype(np.float32),
                init_noise=rng.randn(1, 4, 4, 4).astype(np.float32),
                activations=[rng.randn(3, 4, 4, c).astype(np.float32)
                             for c in (8, 6, 4)],
                latent_image=rng.randn(1, 4, 4, 4).astype(np.float32))


def _same_identity(a, b):
    assert set(a) == set(b)
    for k in ("null_text_emb", "init_noise", "latent_image"):
        np.testing.assert_array_equal(a[k], b[k])
    for x, y in zip(a["activations"], b["activations"]):
        np.testing.assert_array_equal(x, y)


def test_identity_npz_across_packages(tmp_path):
    """An identity written by either package loads in the other to the
    same arrays (NHWC in memory, NCHW with the reference's names on
    disk); the port also takes tensors."""
    ident = _identity(4)
    tckpt.save_identity(tmp_path / "t.npz", ident["null_text_emb"],
                        torch.from_numpy(ident["init_noise"]),
                        [torch.from_numpy(a) for a in ident["activations"]],
                        ident["latent_image"])
    jckpt.save_identity(tmp_path / "j.npz", **ident)
    with np.load(tmp_path / "t.npz") as data:
        assert set(data.files) == {"null_text_emb", "init_noise",
                                   "activations1", "activations2",
                                   "activations3", "latent_image"}
        assert data["activations1"].shape == (3, 8, 4, 4)
    _same_identity(jckpt.load_identity(tmp_path / "t.npz"), ident)
    _same_identity(tckpt.load_identity(tmp_path / "j.npz"), ident)
    x = torch.arange(24.0).reshape(1, 2, 3, 4)
    assert torch.equal(tckpt.to_nchw(tckpt.to_nhwc(x)), x)
    np.testing.assert_array_equal(tckpt.to_nhwc(x.numpy()),
                                  jckpt.to_nhwc(x.numpy()))


def test_safetensors_reader_matches_the_package(tmp_path):
    """The port's reader against safetensors' own, for every dtype it
    reads, with sizes that leave later buffers misaligned."""
    from safetensors.torch import load_file, save_file
    gen = torch.Generator().manual_seed(5)
    tensors = {
        "a.f16": torch.randn(3, generator=gen).half(),
        "b.f32": torch.randn(5, 7, generator=gen),
        "c.bf16": torch.randn(2, 3, 3, generator=gen).bfloat16(),
        "d.i64": torch.arange(77).reshape(1, 77),
        "e.u8": torch.arange(5, dtype=torch.uint8),
        "f.f32": torch.randn(4, generator=gen),
        "g.empty": torch.zeros(0, 3),
    }
    save_file(tensors, str(tmp_path / "m.safetensors"),
              metadata={"format": "pt"})
    got = load_safetensors(tmp_path / "m.safetensors")
    want = load_file(str(tmp_path / "m.safetensors"))
    assert set(got) == set(want) == set(tensors)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
