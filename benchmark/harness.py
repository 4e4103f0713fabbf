"""One run of one cell: set-up, the measured window, the traced request,
the correctness check, and the result line.

Everything specific to a cell is read from files found by name: the
configuration (`BENCHMARK.json`'s "file"), its model family
(`archs/<arch>.py`, named by the configuration's "arch"), the traffic mix
(`traffic/<mix>.json`), the entry that serves the mix's requests and
checks them (`entries/<entry>.py`, named by the mix), the limits of the
correctness check (`limits/<cell>.json`) and one reader per metric,
end-to-end or per-layer (`metrics/<metric>.py`). An arch module has:

    program_modules(cfg) -> ({name: module}, extra)   the program's
                                  models on the meta device, seeded in order
    program_handles(cfg, weights, device) -> handles  the program, built on
                                  the seeded weights
    image_res(cfg) -> int         the image's side in pixels
    tap(cfg) -> UNetTap           the denoiser's class and its call's reading
    shared(cfg, weights, prompt, device) -> sh        the reference's part
                                  of the check, which `readings` receives

An entry module has:

    setup(session) -> state       the cell's own set-up and its warm-up
    serve(session, state, request) -> outputs     one request
    units(request) -> int         edits, photos, ... a request completes
    flops(cfg_json, served) -> float              its model FLOPs
    readings(sh, inp) -> {name: reading}          the correctness check
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import pathlib
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import traffic
from benchmark.tap import Call, UNetTap
from benchmark.trace import Digest, TraceSession
from benchmark.weights import seeded_state_dicts

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diffusionhandles_tpu")


@dataclasses.dataclass
class Session:
    """What an entry gets: the cell's files, the run's seed and device,
    the program's handles, the denoiser's tap and the model family's
    module."""

    cell: dict
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    res: int
    handles: object
    tap: UNetTap
    arch: object


@dataclasses.dataclass
class Served:
    """One request of the window: its inputs, the calls it made, the
    program's outputs, its own seconds and its times in the window."""

    index: int
    request: dict
    calls: list
    outputs: tuple
    seconds: float
    units: int
    timing: Optional[traffic.Timing] = None
    host: Optional[dict] = None


@dataclasses.dataclass
class CheckInput:
    """What an entry's check gets besides the reference (check.Shared)."""

    cfg: dict
    mix: dict
    weights: dict
    state: dict
    served: Served
    seed: int
    control: Optional[Callable] = None


@dataclasses.dataclass
class Run:
    """What a metric's reader gets."""

    cell: dict
    cfg: dict
    mix: dict
    requests: List[Served]
    window_s: float
    units: int
    setup_s: float
    peak_bytes: int
    digest: Optional[Digest]
    flops: Callable[[Served], float]


def cell_files(spec: dict, name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """(cell, configuration, mix, limits) of workload `name`."""
    cell = next(w for w in spec["workloads"] if w["name"] == name)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    if "arch" not in cfg:
        raise ValueError(f"{conf['file']}: no \"arch\" key (the model "
                         "family, archs/<arch>.py)")
    mix = traffic.load_mix(bench_dir / "traffic" / f"{cell['traffic']}.json")
    lim_path = bench_dir / "limits" / f"{name}.json"
    limits = json.loads(lim_path.read_text()) if lim_path.exists() else None
    return cell, cfg, mix, limits


def load_module(kind: str, name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The module `<kind>/<name>.py` under `bench_dir`, else under the
    benchmark's own folder (registered in `sys.modules` under a name of
    its own, as dataclasses need)."""
    path = bench_dir / kind / f"{name}.py"
    if not path.exists():
        path = BENCH_DIR / kind / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[mod_spec.name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The `read` function of metrics/<name>.py."""
    return load_module("metrics", name, bench_dir).read


def load_entry(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    return load_module("entries", name, bench_dir)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, bench_dir: pathlib.Path = BENCH_DIR,
             fault: Optional[Callable] = None,
             control: Optional[Callable] = None) -> dict:
    """One run. `fault`, for the harness's own tests, is called with the
    program's handles after set-up and may break them. `control`
    (control.py) makes the same readings of the check's control, returned
    under "control"."""
    cell, cfg, mix, limits = cell_files(spec, name, bench_dir)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    entry = load_entry(mix["entry"], bench_dir)
    arch = load_module("archs", cfg["arch"], bench_dir)

    # ---- set-up: weights, the program, the entry's own set-up and warm-up
    meta, _ = arch.program_modules(cfg)
    weights = seeded_state_dicts(meta, seed, device)
    del meta
    handles = arch.program_handles(cfg, weights, device)
    tap = arch.tap(cfg)
    session = Session(cell, cfg, mix, seed, device, arch.image_res(cfg),
                      handles, tap, arch)
    served: List[Served] = []
    with tap:
        state = entry.setup(session)
        if fault is not None:
            fault(handles)
        _sync(device)
        setup_s = time.perf_counter() - t_start

        # ---- the measured window
        if cuda:
            torch.cuda.reset_peak_memory_stats()

        def serve(k: int) -> float:
            req = traffic.request(mix, session.res, seed, k)
            calls = tap.begin()
            cpu0, main0 = time.process_time(), time.thread_time()
            r0 = time.perf_counter_ns()
            out = entry.serve(session, state, req)
            r1 = time.perf_counter_ns()
            host = host_phases(calls, r0, r1)
            host.update(cpu_s=time.process_time() - cpu0,
                        main_cpu_s=time.thread_time() - main0)
            took = (r1 - r0) * 1e-9
            served.append(Served(k, req, _park(calls), _park(out), took,
                                 entry.units(req), host=host))
            return took

        timings, window_s = traffic.drive(mix, seed, seconds, serve)
        for s, t in zip(served, timings):
            s.timing = t
        peak = torch.cuda.max_memory_allocated() if cuda else 0

        # ---- the traced request, after the window
        digest = None
        if trace:
            first, last = mix["trace_calls"]
            session_t = TraceSession(first, last)
            tap.on_call = session_t.on_call
            tap.begin()
            entry.serve(session, state,
                        traffic.request(mix, session.res, seed, len(served)))
            session_t.stop()
            tap.on_call = None
            digest = session_t.digest()

    units = sum(s.units for s in served)
    failed = sum(s.units for s in served if not _finite(s.outputs))
    cfg_json = json.dumps(cfg, sort_keys=True)
    run = Run(cell, cfg, mix, served, window_s, units, setup_s, int(peak),
              digest, lambda s: entry.flops(cfg_json, s))

    # ---- metrics: the cell's end-to-end ones, or traced its per-layer ones
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and name not in m["workloads"]:
            continue
        value = load_reader(m["name"], bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # ---- correctness, once the program's state is freed
    del handles, session
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = correctness(entry, arch, CheckInput(
        cfg, mix, weights, state, None, seed, control), served, device)
    control_readings = readings.pop("control", None)
    limits = limits or {}
    correct = bool(limits) and all(
        n in limits and readings[n] <= limits[n]["limit"] for n in readings)
    compared = {n: {"value": v if v != float("inf") else None,
                    "limit": limits.get(n, {}).get("limit")}
                for n, v in readings.items()}

    result = {"correct": bool(correct and not failed),
              "attempted": units, "failed": failed,
              "metrics": metrics, "device": device_info(device, peak)}
    if digest is not None:
        result["device"].update(busy_s=digest.busy_s,
                                window_s=digest.window_s)
        result["breakdown"] = {"device_ops": digest.device_ops,
                               "idle_gaps": digest.idle_gaps}
    result["requests_s"] = [s.seconds for s in served]
    result["requests_host"] = [s.host for s in served]
    if control is not None:
        result["control"] = control_readings
    result["compared"] = compared
    return result


def host_phases(calls, start_ns: int, end_ns: int) -> dict:
    """A request's seconds on the host clock (no synchronize, so where the
    device waits on the host they are its progress too): before its first
    U-Net call ("pre_s": the depth transform, the inputs), from each call
    to the next for calls that record a graph ("graph_s": forward,
    backward and update) and for forwards ("forward_s"), and from the last
    call to the end ("post_s": that call, the decode, the copy back)."""
    out = dict(pre_s=0.0, graph_s=0.0, forward_s=0.0, post_s=0.0)
    if not calls:
        out["pre_s"] = (end_ns - start_ns) * 1e-9
        return out
    out["pre_s"] = (calls[0].start_ns - start_ns) * 1e-9
    for c, nxt in zip(calls, calls[1:]):
        out["graph_s" if c.grad else "forward_s"] += (
            nxt.start_ns - c.start_ns) * 1e-9
    out["post_s"] = (end_ns - calls[-1].start_ns) * 1e-9
    return out


def _park(x):
    """A finished request's record moved to the host, so that what the
    harness keeps does not grow the device's memory with the number of
    requests (the time this takes is not in the window)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_park(v) for v in x)
    if isinstance(x, Call):
        x.latents = x.latents.cpu()
        x.acts = _park(x.acts)
    return x


def _unpark(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (list, tuple)):
        return type(x)(_unpark(v, device) for v in x)
    if isinstance(x, Call):
        x.latents = x.latents.to(device)
        x.acts = _unpark(x.acts, device)
    return x


def _finite(outputs) -> bool:
    for o in outputs:
        if isinstance(o, (list, tuple)):
            if not _finite(o):
                return False
        elif o is not None and not bool(
                torch.isfinite(torch.as_tensor(np.asarray(o) if isinstance(
                    o, np.ndarray) else o)).all()):
            return False
    return True


def correctness(entry, arch, inp: CheckInput, served: List[Served],
                device) -> Dict[str, float]:
    """The entry's check of a request drawn from the seed among those the
    window finished, against the reference built on the run's weights."""
    sh = arch.shared(inp.cfg, inp.weights, inp.mix["prompt"], device)
    s = served[traffic.sample_indices(len(served), 1, inp.seed, 0)[0]]
    s.calls = _unpark(s.calls, device)
    s.outputs = _unpark(s.outputs, device)
    inp.served = s
    try:
        return entry.readings(sh, inp)
    except ValueError as err:
        print(f"check: the program's loop could not be followed: {err}",
              file=sys.stderr)
        return {"loop": float("inf")}


def device_info(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    import subprocess
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i",
             str(device.index or 0)],
            capture_output=True, text=True, timeout=30, check=True)
        limit = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak),
            "power_limit_w": limit}


def forbidden_modules() -> List[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)
