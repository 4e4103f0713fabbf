"""The yardstick's counts against hand counts, and the trace digest on
made-up events."""

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import counting, trace  # noqa: E402
from benchmark.tap import SiteRecorder  # noqa: E402

FIXTURE = ROOT / "benchmark" / "tests" / "fixture"


def test_attention_site_by_hand():
    # the U-Net's first long self-attention: [1, 4096, 5, 64]
    b, s, h, d = 1, 4096, 5, 64
    flops, nbytes = counting.attention_fwd(b, s, s, h, d)
    assert flops == 2 * (2 * 4096 * 4096 * 64) * 5 == 21_474_836_480
    # q, k, v in and o out, bf16; the fp32 log-sum-exp out
    assert nbytes == 4 * (4096 * 5 * 64 * 2) + 5 * 4096 * 4 == 10_567_680
    flops, nbytes = counting.attention_bwd(b, s, s, h, d)
    assert flops == 4 * (2 * 4096 * 4096 * 64) * 5 == 42_949_672_960
    # q, k, v, o, dO and lse in; dq, dk, dv out
    assert nbytes == (5 + 3) * (4096 * 5 * 64 * 2) + 5 * 4096 * 4
    # PERF.md's kernel table: K1's bound 0.0217 ms by operations
    fwd = counting.attention_fwd(b, s, s, h, d)
    assert counting.bound_s(*fwd) * 1e3 == pytest.approx(0.0217, abs=1e-4)


def test_conv_site_by_hand():
    # a resnet half at 64x64, 320 -> 320 channels, 32 groups
    flops, nbytes = counting.gn_silu_conv3x3_fwd(1, 64, 64, 320, 320, 32)
    n = 64 * 64
    assert flops == 2 * 9 * n * 320 * 320 + 10 * n * 320
    assert nbytes == (2 * n * 320 + 2 * 9 * 320 * 320 + 4 * 2 * 320
                      + 2 * (n * 320 + n * 320) + 4 * 2 * 32)
    flops, nbytes = counting.gn_silu_conv3x3_dx(1, 64, 64, 320, 320, 32)
    assert flops == 2 * 9 * n * 320 * 320 + 20 * n * 320
    assert nbytes == (2 * (n * 320 + 9 * 320 * 320 + n * 320) + 4 * 2 * 320
                      + 4 * 2 * 32 + 2 * n * 320)
    # PERF.md's kernel table: K9's bound 0.0076 ms by operations
    assert counting.bound_s(flops, nbytes) * 1e3 == pytest.approx(
        0.0076, abs=1e-4)


def test_unet_flops_scale_and_backward():
    cfg = json.dumps(json.loads((FIXTURE / "configs" / "toy.json")
                                .read_text()), sort_keys=True)
    one = counting.unet_call_flops(cfg, 1, "")
    assert one > 0
    assert counting.unet_call_flops(cfg, 2, "") == pytest.approx(2 * one)
    lat = counting.unet_call_flops(cfg, 1, "latents")
    ctx = counting.unet_call_flops(cfg, 1, "context")
    # a backward to the inputs only costs about one more forward, never
    # the two that weight gradients would add
    assert one < lat < 3 * one
    assert one < ctx < 3 * one
    assert counting.vae_flops(cfg, "decode") > 0


class _Ev:
    def __init__(self, name, start, end, cuda):
        self._n, self._s, self._e, self._c = name, start, end, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"


def _events():
    return [
        _Ev("aten::conv2d", 0, 400, False),
        _Ev("aten::item", 500, 900, False),
        _Ev("void flash_fwd_kernel<2, 128>(CUtensorMap)", 100, 300, True),
        # overlaps the first kernel: counted once in the busy time
        _Ev("nchwToNhwcKernel", 200, 350, True),
        _Ev("void flash_fwd_kernel<2, 128>(CUtensorMap)", 950, 1000, True),
    ]


def test_digest_union_and_gaps():
    rec = SiteRecorder()
    rec.attention = [(1, 4096, 4096, 5, 64, False)] * 2
    d = trace.digest(_events(), rec, {"K1": 2, "K2": 0, "K9": 0})
    assert d.window_s == pytest.approx(1000e-9)
    assert d.busy_s == pytest.approx((350 - 100 + 50) * 1e-9)
    assert d.device_s == pytest.approx((200 + 150 + 50) * 1e-9)
    assert d.kernel_s["K1"] == pytest.approx(250e-9)
    assert d.layout_copy_s == pytest.approx(150e-9)
    gaps = dict(d.idle_gaps)
    # 0-100 under conv2d, 350-950 under item (mid 650)
    assert gaps["aten::conv2d"] == pytest.approx(100e-9)
    assert gaps["aten::item"] == pytest.approx(600e-9)
    assert d.kernel_bound_s["K1"] == pytest.approx(
        2 * counting.bound_s(*counting.attention_fwd(1, 4096, 4096, 5, 64)))


def test_digest_refuses_disagreeing_counts():
    rec = SiteRecorder()
    rec.attention = [(1, 4096, 4096, 5, 64, False)] * 2
    with pytest.raises(trace.TraceError):
        trace.digest(_events(), rec, {"K1": 3, "K2": 0, "K9": 0})
    with pytest.raises(trace.TraceError):
        trace.digest(_events(), rec, {"K1": 2, "K2": 1, "K9": 0})
    with pytest.raises(trace.TraceError):
        trace.digest([e for e in _events() if not e._c], rec,
                     {"K1": 2, "K2": 0, "K9": 0})
