"""The SDXL family's cell (`archs/sdxl_depth_cn.py`, entry
`transform_foreground_cn`) on the CPU at a tiny SDXL shape: the
configuration of `edit.sdxl-depth-cn-1024` with its widths cut to test
sizes, run by the harness like any cell. The program agrees with the
reference step by step, the fp8 control and a planted fault (the
ControlNet's residuals switched off after set-up) do not, and the reader
of the ControlNet's share reads nothing where no trace was taken."""

import dataclasses
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import control, harness, trace_spans  # noqa: E402

SEED = 2 ** 33 + 17
LIMIT = 1e-3  # float32 on both sides: the readings are about 1e-6


def _tiny(tmp_path: pathlib.Path) -> dict:
    """A spec of one cell on the tiny SDXL configuration, its mix and
    limits under `tmp_path`."""
    cfg = json.loads((ROOT / "benchmark/configs/sdxl-depth-cn-1024.json")
                     .read_text())
    net = dict(block_out_channels=[32, 32, 64], attention_head_dim=[2, 2, 2],
               transformer_layers_per_block=[1, 1, 2],
               cross_attention_dim=80, norm_num_groups=8, layers_per_block=1,
               addition_time_embed_dim=8,
               projection_class_embeddings_input_dim=40 + 6 * 8)
    cfg["unet"].update(net, sample_size=8)
    cfg["controlnet"].update(net, conditioning_embedding_out_channels=[4, 8,
                                                                       16])
    cfg["vae"].update(block_out_channels=[16, 16, 32], layers_per_block=1,
                      norm_num_groups=8)
    tower = dict(vocab_size=1024, num_attention_heads=2, num_hidden_layers=2)
    cfg["text_encoder"].update(tower, hidden_size=32, intermediate_size=64)
    cfg["text_encoder_2"].update(tower, hidden_size=48, intermediate_size=96,
                                 projection_dim=40)
    cfg["guided_diffuser"].update(num_timesteps=6, guidance_max_step=4,
                                  dtype="float32", param_dtype="float32",
                                  flash_attention=False)
    (tmp_path / "traffic").mkdir()
    (tmp_path / "limits").mkdir()
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "benchmark/traffic/edit_cn.json").read_text())
    mix["trace_calls"] = [2, 5]
    (tmp_path / "traffic" / "edit_cn.json").write_text(json.dumps(mix))
    names = ("recording", "disparity", "guidance_fwd", "guidance", "cfg",
             "image")
    (tmp_path / "limits" / "edit.tiny.json").write_text(json.dumps(
        {n: {"limit": LIMIT} for n in names}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny", "file": str(tmp_path / "tiny.json"),
                        "reduced": []}]
    spec["workloads"] = [{"name": "edit.tiny", "config": "tiny",
                          "traffic": "edit_cn", "chips": 1}]
    return spec


def _run(tmp_path, **kwargs):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(_tiny(tmp_path), "edit.tiny", SEED, 0.0,
                                False, "cpu", time.perf_counter(),
                                bench_dir=tmp_path, **kwargs)
    finally:
        torch.set_num_threads(threads)


def test_sdxl_cell_is_correct_and_its_control_is_not(tmp_path):
    r = _run(tmp_path, control=control.control_readings)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    ctl = r["control"]
    assert any(ctl[n] > LIMIT for n in r["compared"])
    assert ctl["fault_negated"]["guidance"] > 1.0
    assert ctl["fault_wrong_step"]["guidance"] > LIMIT


def test_sdxl_cell_sees_the_controlnet_switched_off(tmp_path):
    def fault(handles):
        cn = handles.diffuser.models.controlnet
        cn.cn_config = dataclasses.replace(cn.cn_config,
                                           conditioning_scale=0.0)
    r = _run(tmp_path, fault=fault)
    assert not r["correct"]
    assert r["compared"]["cfg"]["value"] > LIMIT


def test_controlnet_share_reader_finds_no_trace_without_one():
    trace_spans._SESSIONS.clear()
    assert trace_spans.share("controlnet") is None
    reader = harness.load_reader("controlnet_share.edit")

    class _Run:
        digest = None
    assert reader(_Run()) is None
