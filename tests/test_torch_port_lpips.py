"""LPIPS: PyTorch port vs the JAX package on the CPU; the port's device
trace.

LPIPS runs the same weights in both packages (random JAX parameters made
by shape, carried into the port by `lpips_state_dict`) on 64x64 images,
within LPIPS_RTOL: VGG16's 13 fp32 convs sum in other orders in XLA and
ATen. `convert_lpips_weights` maps a torchvision-named dict the test
writes to what the JAX converter makes of it. `device_trace` writes the
program's spans into its chrome trace.
"""

import json

import jax
import numpy as np
import pytest
import torch

from diffusionhandles_tpu.models import lpips as jlpips
from diffusionhandles_tpu_torch.models import lpips as tlpips
from diffusionhandles_tpu_torch.utils import profiling as tprof
from torch_port_rig import random_flax_params

LPIPS_RTOL = 1e-4


@pytest.fixture(scope="module")
def params():
    x = np.zeros((1, 32, 32, 3), np.float32)
    return random_flax_params(
        lambda key: jlpips.LPIPS().init(key, x, x), seed=0)


def test_lpips_matches_jax(params):
    rng = np.random.RandomState(1)
    a = rng.rand(1, 3, 64, 64).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(1, 3, 64, 64), 0, 1).astype(np.float32)
    want = jlpips.LPIPSMetric(params=params)
    got = tlpips.LPIPSMetric(params=tlpips.lpips_state_dict(params),
                             device="cpu")
    for x, y in ((a, b), (a[0], b[0]), (b, a)):
        w, g = want(x, y), got(x, y)
        assert isinstance(g, float)
        assert abs(g - w) <= LPIPS_RTOL * abs(w), (g, w)
    assert got(a, a) == 0.0
    # a batch: one distance per image pair
    with torch.no_grad():
        d = got.model(torch.from_numpy(np.concatenate([a, b])),
                      torch.from_numpy(np.concatenate([b, b])))
    assert d.shape == (2,) and float(d[1]) == 0.0
    np.testing.assert_allclose(float(d[0]), got(a, b), rtol=1e-6)


def test_convert_lpips_weights_matches_jax():
    """A torchvision VGG16 `features.*` dict and LPIPS `lin<i>.model.1`
    heads: the port's converter gives the state dict the JAX converter's
    tree carries, and the port's module loads it strictly."""
    rng = np.random.RandomState(2)
    vgg, lin = {}, {}
    cin = 3
    conv_ids = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
    widths = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
    for cid, ch in zip(conv_ids, widths):
        vgg[f"features.{cid}.weight"] = rng.randn(ch, cin, 3, 3).astype(
            np.float32)
        vgg[f"features.{cid}.bias"] = rng.randn(ch).astype(np.float32)
        cin = ch
    for i, ch in enumerate((64, 128, 256, 512, 512)):
        lin[f"lin{i}.model.1.weight"] = rng.rand(1, ch, 1, 1).astype(
            np.float32)
    got = tlpips.convert_lpips_weights(
        {k: torch.from_numpy(v) for k, v in vgg.items()}, lin)
    want = tlpips.lpips_state_dict(jlpips.convert_lpips_weights(vgg, lin))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    metric = tlpips.LPIPSMetric(params=got, device="cpu")
    assert set(metric.model.state_dict()) == set(got)
    del got["lin_4"]
    with pytest.raises(RuntimeError, match="lin_4"):
        tlpips.LPIPSMetric(params=got, device="cpu")


def test_lpips_seeded_default():
    """Without params the weights are seeded: one seed, one distance."""
    a = np.random.RandomState(3).rand(3, 32, 32).astype(np.float32)
    b = a[:, ::-1].copy()
    d = [tlpips.LPIPSMetric(seed=s, device="cpu")(a, b) for s in (0, 0, 1)]
    assert d[0] == d[1] != d[2]
    assert d[0] > 0


def test_device_trace_holds_spans(tmp_path):
    """device_trace writes a chrome trace that holds the program's spans
    opened inside it, as CPU events."""
    with tprof.device_trace(str(tmp_path / "trace")):
        with tprof.span("unet"):
            torch.ones(4).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert "unet" in {e.get("name") for e in trace["traceEvents"]}
