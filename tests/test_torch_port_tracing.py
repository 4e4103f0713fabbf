"""The port's spans (`utils/profiling.py`) and the benchmark's readers of
them, on the CPU.

The span module: nothing is recorded with tracing off; parents and the
request id follow the nesting; a raising block closes its span; the record
keeps its bound; under a CPU `torch.profiler` every span is a kineto event
on the same clock. The loops: a tiny edit and a tiny inversion under
`tracing()` record their structure (steps, guidance iterations and their
three parts, one `unet` span per U-Net call, one loss read per null-text
inner step), and give the same bits as with tracing off. The readers
(`benchmark/metrics/`): each of the five on a synthetic record.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from diffusionhandles_tpu_torch import config as tconfig
from diffusionhandles_tpu_torch.pipeline import DiffusionHandles
from diffusionhandles_tpu_torch.utils import profiling
from torch_port_rig import one_thread, sample

ROOT = pathlib.Path(__file__).resolve().parents[1]
T, GMS, OPT = 2, 1, 2


@pytest.fixture(autouse=True)
def _empty_record():
    profiling.clear()
    yield
    profiling.clear()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_records_nothing():
    with profiling.request("edit"):
        with profiling.span("step"):
            pass
    assert profiling.span("x") is profiling.span("y")
    assert profiling.spans() == []


def test_nesting_parents_and_request_ids():
    with profiling.tracing():
        with profiling.request("edit"):
            with profiling.span("step"):
                with profiling.span("unet"):
                    pass
                with profiling.request("record"):   # nested: same request
                    pass
        with profiling.request("edit"):
            pass
    got = _by_name(profiling.spans())
    (edit, edit2), (step,), (unet,), (rec,) = (
        got["edit"], got["step"], got["unet"], got["record"])
    assert edit.parent == -1 and step.parent == edit.index
    assert unet.parent == step.index and rec.parent == step.index
    assert edit.request == step.request == unet.request == rec.request > 0
    assert edit2.request != edit.request
    assert edit.start_ns <= step.start_ns <= unet.start_ns
    assert unet.end_ns <= step.end_ns <= edit.end_ns


def test_raising_block_closes_its_span():
    with profiling.tracing():
        with pytest.raises(ValueError):
            with profiling.request("edit"):
                with profiling.span("step"):
                    raise ValueError
        with profiling.span("after"):
            pass
    got = _by_name(profiling.spans())
    assert set(got) == {"edit", "step", "after"}
    assert not any(s.profiled for s in profiling.spans())
    assert got["after"][0].parent == -1 and got["after"][0].request == 0


def test_record_keeps_its_bound():
    with profiling.tracing():
        for _ in range(profiling.MAX_SPANS + 5):
            with profiling.span("s"):
                pass
    got = profiling.spans()
    assert len(got) == profiling.MAX_SPANS
    assert got[-1].index - got[0].index == profiling.MAX_SPANS - 1


def test_spans_are_profiler_events_on_its_clock():
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(64, 64)
    # the last of three sessions: a process's first record_function, and a
    # session's, pay a one-time cost of up to a few hundred microseconds
    for _ in range(3):
        profiling.clear()
        with profiling.span("before"):   # entered before: does not record
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                x @ x
                for i in range(4):
                    with profiling.span(f"span{i}"):
                        with profiling.span(f"inner{i}"):
                            x @ x
                across = profiling.span("across")   # outlives the profile
                across.__enter__()
            across.__exit__(None, None, None)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    got = profiling.spans()
    assert sorted(s.name for s in got) == sorted(
        [f"span{i}" for i in range(4)] + [f"inner{i}" for i in range(4)]
        + ["across"])
    assert [s.name for s in got if not s.profiled] == ["across"]
    assert "across" in events
    for s in got[:-1]:
        e = events[s.name]
        assert abs(s.start_ns - e.start_ns()) < 100_000, s.name
        assert abs(s.end_ns - (e.start_ns() + e.duration_ns())) < 100_000


@pytest.fixture(scope="module")
def tiny():
    conf = tconfig.DiffusionHandlesConfig()
    g = conf.guided_diffuser
    g.num_timesteps, g.guidance_max_step, g.num_optsteps = T, GMS, OPT
    g.dtype = g.param_dtype = g.activation_store_dtype = "float32"
    h = DiffusionHandles(conf, variant="tiny", device="cpu")
    return h, sample(h.img_res)


def _invert_and_edit(h, s):
    null, noise = h.invert_input_image(s["img"], s["depth"], "a cube")
    null, noise, acts, _ = h.generate_input_image(s["depth"], "a cube",
                                                  null, noise)
    img, disp = h.transform_foreground(
        s["depth"], "a cube", s["fg_mask"], s["bg_depth"], null, noise,
        acts, rot_angle=10.0, rot_axis=np.array([0.0, 1.0, 0.0]))
    return null, noise, img, disp


def test_loops_record_their_structure_and_keep_their_bits(tiny):
    h, s = tiny
    calls = []
    hook = h.diffuser.models.unet.register_forward_hook(
        lambda *a: calls.append(1))
    try:
        with one_thread():
            want = _invert_and_edit(h, s)
            assert profiling.spans() == []
            n_off = len(calls)
            with profiling.tracing():
                got = _invert_and_edit(h, s)
    finally:
        hook.remove()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    spans = profiling.spans()
    index = {sp.index: sp for sp in spans}
    reqs = {}
    for sp in spans:
        reqs.setdefault(sp.request, []).append(sp)
    (inv,), (rec,), (edit,) = ([r for r in reqs.values()
                                if any(sp.name == n and sp.parent == -1
                                       for sp in r)] for n in
                               ("invert", "record", "edit"))
    assert len(reqs) == 3
    assert sum(sp.name == "unet" for sp in spans) == len(calls) - n_off

    e = _by_name(edit)
    assert len(e["step"]) == T and len(e["cfg.step"]) == T
    assert len(e["guidance.opt_step"]) == GMS * OPT
    for child in ("guidance.energy", "guidance.backward", "guidance.update"):
        assert sorted(index[c.parent].name for c in e[child]) == \
            ["guidance.opt_step"] * (GMS * OPT), child
    for key in ("depth_transform", "vae.decode", "sync.image_to_host"):
        assert len(e[key]) == 1, key

    i = _by_name(inv)
    assert len(i["invert.ddim_step"]) == T and len(i["null_text.step"]) == T
    inner = i["null_text.inner"]
    assert T <= len(inner) <= 5 * T
    for child in ("null_text.backward", "null_text.adam",
                  "sync.null_text_loss"):
        assert len(i[child]) == len(inner), child
        assert all(index[c.parent].name == "null_text.inner"
                   for c in i[child])
    assert len(i["vae.encode"]) == 1
    # the fused capture is served: no U-Net call in the record request
    assert {sp.name for sp in rec} == {"record"}


def _reader(name):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.harness import load_reader
    return load_reader(name)


def _span(name, ms, index=0, profiled=True):
    return profiling.Span(index, name, 0, int(ms * 1e6), -1, 1, profiled)


@pytest.mark.parametrize("metric, spans, want", [
    ("energy_host_ms.edit", [("guidance.energy", 2.0),
                             ("guidance.energy", 4.0), ("unet", 50.0)], 3.0),
    ("backward_host_ms.edit", [("guidance.backward", 30.0),
                               ("guidance.energy", 4.0)], 30.0),
    ("null_inner_host_ms.invert", [("null_text.inner", 10.0),
                                   ("null_text.inner", 20.0),
                                   ("null_text.inner", 900.0, False),
                                   ("null_text.adam", 1.0)], 15.0),
    ("syncs_per_call.edit", [("unet", 1.0)] * 4 + [("sync.timestep", 0.1)] * 4
     + [("sync.image_to_host", 0.1), ("step", 1.0)], 1.25),
    ("syncs_per_call.invert", [("unet", 1.0)] * 2
     + [("sync.null_text_loss", 0.1)], 0.5),
])
def test_readers_on_a_synthetic_record(monkeypatch, metric, spans, want):
    read = _reader(metric)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(None) is None
    record = [_span(*sp[:2], k, *sp[2:]) for k, sp in enumerate(spans)]
    monkeypatch.setattr(profiling, "spans", lambda: record)
    assert read(None) == pytest.approx(want)
    monkeypatch.delattr(profiling, "spans")   # a program without spans
    assert read(None) is None
