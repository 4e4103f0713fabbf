"""The harness on the CPU at a toy size: the spec and its files load by
name, a run's result line has the contract's keys, the reference and the
port agree step by step, and faults in the timed path make `correct`
false. The toy cells live in tests/fixture/ and are named by no harness
code: a cell, configuration, mix, limits file or metric is added as files
and entries alone."""

import json
import pathlib
import re
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, traffic  # noqa: E402

BENCH = ROOT / "benchmark"
FIXTURE = BENCH / "tests" / "fixture"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2 ** 31 + 977


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert {"setup_s", "edit_s", "invert_s", "peak_gib"} == e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert any(x["name"] == w for x in SPEC["workloads"])
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_loads_by_name(cell):
    c, cfg, mix, limits = harness.cell_files(SPEC, cell)
    entry = harness.load_entry(mix["entry"])
    for hook in ("setup", "serve", "units", "flops", "readings"):
        assert callable(getattr(entry, hook))
    assert limits is not None and limits
    assert cfg["reduced"] == [] and cfg["unet"]["block_out_channels"] == [
        320, 640, 1280, 1280]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def _fixture_spec():
    return json.loads((FIXTURE / "BENCHMARK.json").read_text())


def _run(cell, trace=False, fault=None, seed=SEED, seconds=0.0):
    """One toy run on one CPU thread: the program's batched backward sums
    in another order on more threads, and the toy's float32 guidance
    residuals near zero turn that into other signs from run to run."""
    torch.manual_seed(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(_fixture_spec(), cell, seed, seconds, trace,
                                "cpu", time.perf_counter(),
                                bench_dir=FIXTURE, fault=fault)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", ["toy_edit.toy", "toy_batch4.toy",
                                  "toy_invert.toy", "toy_sample.toy_side"])
def test_toy_cell_runs_and_is_correct(cell):
    r = _run(cell)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "compared"
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) == 3
    for c in r["compared"].values():
        assert c["value"] <= c["limit"]
    for took, host in zip(r["requests_s"], r["requests_host"]):
        phases = sum(host[k] for k in ("pre_s", "graph_s", "forward_s",
                                       "post_s"))
        assert phases == pytest.approx(took, rel=1e-6)


def test_fixture_entry_serves_an_open_loop():
    """A cell whose entry, open-loop mix and end-to-end metric exist only
    as fixture files: requests arrive on the clock, wait while an earlier
    one is served, and the latency is read from their times."""
    r = _run("toy_batch4.toy", seconds=1.5)
    assert r["correct"], r["compared"]
    assert len(r["requests_s"]) >= 2
    lat = r["metrics"]["toy_latency_max_s"]["value"]
    assert lat >= max(r["requests_s"])
    assert "edit_s" not in r["metrics"]


def test_open_loop_arrivals_are_one_set_in_seeded_order():
    mix = {"loop": "open", "rate_per_s": 3.0}
    a = traffic.arrival_gaps(mix, 2 ** 31 + 5, 10.0)
    b = traffic.arrival_gaps(mix, 2 ** 31 + 6, 10.0)
    assert sorted(a) == sorted(b) and list(a) != list(b)
    served = []
    timings, window = traffic.drive(mix, 7, 0.5,
                                    lambda k: served.append(k) or 0.01)
    assert served == list(range(len(timings)))
    assert all(t.start >= t.arrival - 1e-6 for t in timings)
    assert window >= timings[-1].arrival

def test_fixture_metric_is_read_by_name():
    """A per-layer metric that exists only as a fixture file."""
    spec = _fixture_spec()
    spec["per_layer"] = [{"name": "toy_requests", "unit": "1",
                          "better": "higher", "source": "host_clock",
                          "layer": "loops", "moves": "edit_s",
                          "workloads": ["toy_edit.toy"]}]
    read = harness.load_reader("toy_requests", FIXTURE)

    class _R:
        requests = [1, 2, 3]
    assert read(_R()) == 3


def test_config_without_arch_is_refused(tmp_path):
    spec = _fixture_spec()
    conf = json.loads((FIXTURE / "configs" / "toy.json").read_text())
    del conf["arch"]
    path = tmp_path / "no_arch.json"
    path.write_text(json.dumps(conf))
    spec["configs"][0]["file"] = str(path)
    with pytest.raises(ValueError, match=r"no_arch\.json: no \"arch\" key"):
        harness.cell_files(spec, "toy_edit.toy", FIXTURE)


def test_tap_records_the_wrapper_not_its_unet():
    """The toy_side family's tap sees the wrapper's calls (its whole
    4-channel sample, at the CFG batch), and none of the calls that the
    wrapper makes to the port's U-Net inside it."""
    from benchmark.weights import seeded_state_dicts
    spec = _fixture_spec()
    cell, cfg, mix, _ = harness.cell_files(spec, "toy_sample.toy_side",
                                           FIXTURE)
    arch = harness.load_module("archs", cfg["arch"], FIXTURE)
    meta, _ = arch.program_modules(cfg)
    handles = arch.program_handles(
        cfg, seeded_state_dicts(meta, SEED, "cpu"), "cpu")
    inner = []
    handles.denoiser.unet.register_forward_hook(
        lambda mod, args, out: inner.append(args[0].shape))
    tap = arch.tap(cfg)
    assert tap.cls is type(handles.denoiser)
    assert tap.cls is not type(handles.denoiser.unet)
    session = harness.Session(cell, cfg, mix, SEED, torch.device("cpu"),
                              arch.image_res(cfg), handles, tap, arch)
    entry = harness.load_entry(mix["entry"], FIXTURE)
    with tap:
        calls = tap.begin()
        entry.serve(session, {}, traffic.request(mix, session.res, SEED, 0))
    steps = cfg["sampler"]["num_timesteps"]
    assert len(calls) == len(inner) == steps
    assert [tuple(c.latents.shape) for c in calls] == [(2, 4, 8, 8)] * steps
    assert not any(c.grad for c in calls)


def _side_residual_dropped(handles):
    handles.denoiser.side.register_forward_hook(
        lambda mod, args, out: torch.zeros_like(out))


def test_side_residual_dropped_fails():
    r = _run("toy_sample.toy_side", fault=_side_residual_dropped)
    assert not r["correct"]
    assert r["compared"]["steps"]["value"] > r["compared"]["steps"]["limit"]


def _no_guidance(handles):
    handles.diffuser.conf.guidance_lr = 0.0


def _negated_guidance(handles):
    conf = handles.diffuser.conf
    conf.guidance_lr = -conf.guidance_lr


def _wrong_recording_step(handles):
    """The energy is taken against the recording of the next step."""
    d = handles.diffuser
    guided = d.guided_inference

    def shifted(*args, activations_orig, **kwargs):
        acts = [torch.roll(torch.as_tensor(a), -1, 0)
                for a in activations_orig]
        return guided(*args, activations_orig=acts, **kwargs)
    d.guided_inference = shifted


def _altered_image(handles):
    d = handles.diffuser
    decode = d.decode_latent_image
    d.decode_latent_image = lambda z: decode(z) * 0.9


@pytest.mark.parametrize("fault,reading", [
    (_no_guidance, "guidance"), (_negated_guidance, "guidance"),
    (_wrong_recording_step, "guidance"), (_altered_image, "image")])
def test_edit_faults_fail(fault, reading):
    r = _run("toy_edit.toy", fault=fault)
    assert not r["correct"]
    assert r["compared"][reading]["value"] > r["compared"][reading]["limit"]


def test_step_left_unchanged_fails(monkeypatch):
    from diffusionhandles_tpu_torch import diffuser
    monkeypatch.setattr(diffuser, "ddim_step",
                        lambda sched, eps, i, sample: sample.float())
    r = _run("toy_edit.toy")
    assert not r["correct"]
    assert r["compared"]["cfg"]["value"] > r["compared"]["cfg"]["limit"]


def test_half_batch_left_out_fails(monkeypatch):
    """Rows 2 and 3 of the batched edit take rows 0 and 1's step."""
    from diffusionhandles_tpu_torch.parallel import batch
    step = batch.ddim_step

    def half(sched, eps, i, sample):
        out = step(sched, eps, i, sample)
        h = out.shape[0] // 2
        return torch.cat([out[:h], out[:h]]) if h else out
    monkeypatch.setattr(batch, "ddim_step", half)
    r = _run("toy_batch4.toy")
    assert not r["correct"]
    assert r["compared"]["cfg"]["value"] > r["compared"]["cfg"]["limit"]


def test_invert_faults_fail(monkeypatch):
    from diffusionhandles_tpu_torch import inverter
    monkeypatch.setattr(inverter, "ddim_next_step",
                        lambda sched, eps, i, sample: sample.float())
    r = _run("toy_invert.toy")
    assert not r["correct"]
    assert (r["compared"]["inversion"]["value"]
            > r["compared"]["inversion"]["limit"])


def _null_text_unchanged(handles):
    """The null-text optimisation hands back the embedding it started
    from at every step (its CFG steps still use the optimised one)."""
    inv = handles.inverter
    optimise = inv.null_optimization

    def unchanged(traj, depth64, uncond0, *args, **kwargs):
        out = optimise(traj, depth64, uncond0, *args, **kwargs)
        seq = out[0] if isinstance(out, tuple) else out
        same = uncond0.detach().reshape(1, *seq.shape[1:]).expand_as(seq)
        return (same,) + out[1:] if isinstance(out, tuple) else same
    inv.null_optimization = unchanged


def test_null_text_unchanged_fails():
    r = _run("toy_invert.toy", fault=_null_text_unchanged)
    assert not r["correct"]
    assert (r["compared"]["null_loss"]["value"]
            > r["compared"]["null_loss"]["limit"])


def test_null_loss_is_pooled_over_steps():
    """Losses (before, reference, program) of a sound inversion on the
    card: at the last step the reference's fall is one float32 rounding,
    so that step's own ratio read 1.0; pooled, the steps read as the
    sound run they are, and an embedding left unchanged reads 1."""
    from benchmark import check
    sound = [(0.049042828381061554, 0.009754939004778862,
              0.009702429175376892),
             (0.1850178986787796, 0.14789028465747833, 0.14790058135986328),
             (0.9652711153030396, 0.9506340622901917, 0.9506166577339172),
             (0.48477745056152344, 0.48477742075920105,
              0.48477745056152344)]
    assert check.loss_missed(sound) < 2e-4
    unchanged = [(before, want, before) for before, want, _ in sound]
    assert check.loss_missed(unchanged) == pytest.approx(1.0)
    assert check.loss_missed([(0.5, 0.5, 0.5)]) == 0.0


def test_guidance_call_indices_follow_the_loop():
    from benchmark import check
    gd = {"num_timesteps": 4, "guidance_max_step": 2, "num_optsteps": 2}
    order = []
    for i in range(gd["num_timesteps"]):
        for it in range(gd["num_optsteps"] if i < 2 else 0):
            order.append((i, it))
        order.append("cfg")
    for i in range(2):
        for it in range(2):
            assert order[check.guidance_call_index(i, it, 2)] == (i, it)


def test_requests_are_drawn_from_the_seed():
    mix = traffic.load_mix(BENCH / "traffic" / "edit.json")
    a = traffic.transforms(mix, 2 ** 31 + 5, 3)
    assert a == traffic.transforms(mix, 2 ** 31 + 5, 3)
    assert a != traffic.transforms(mix, 2 ** 31 + 6, 3)
    assert -30 <= a[0]["rotation_angle"] <= 30
    p = traffic.photo(mix, 64, 7, 0)
    assert p["img"].shape == (1, 3, 64, 64) and p["fg_mask"].sum() > 0
