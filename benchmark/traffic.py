"""The one traffic generator: reads a mix file (`traffic/<mix>.json`),
draws each request's inputs from the run's seed, and drives the window.

A mix names the entry that serves a request ("entry": `entries/<entry>.py`),
the rows of a request ("batch"), the prompt, the photo's layout, the
ranges that each transform is drawn from, and how requests arrive
("loop"): "closed", one client that sends the next request when the last
has returned, or "open", requests arriving at "rate_per_s" whether or not
the last has returned, served one at a time in arrival order. Request k
of a run draws from the seed sequence (seed, k), so it is the same
whatever came before it; every seed gives requests of the same sizes, and
an open loop's gaps between arrivals are one fixed set in an order drawn
from the seed.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import time
from typing import Callable, List, Tuple

import numpy as np

WARMUP = -1  # the index of the request served in set-up
LOOPS = ("closed", "open")


def load_mix(path: pathlib.Path) -> dict:
    mix = json.loads(pathlib.Path(path).read_text())
    loop = mix.get("loop")
    if loop not in LOOPS:
        raise ValueError(f"{path}: loop {loop!r} is not one of {LOOPS}")
    if loop == "closed" and mix.get("clients") != 1:
        raise ValueError(f"{path}: a closed loop has one client")
    if loop == "open" and not mix.get("rate_per_s", 0) > 0:
        raise ValueError(f"{path}: an open loop needs rate_per_s > 0")
    return mix


@dataclasses.dataclass
class Timing:
    """A request's times, in seconds from the window's start."""

    arrival: float
    start: float
    finish: float


def arrival_gaps(mix: dict, seed: int, seconds: float) -> np.ndarray:
    """An open loop's gaps between arrivals: exponential at the mix's
    rate, one fixed set for a window of `seconds`, ordered by the seed."""
    rate = float(mix["rate_per_s"])
    n = int(math.ceil(1.5 * rate * seconds)) + 16
    gaps = np.random.default_rng(0).exponential(1.0 / rate, n)
    return _rng(seed, 0, 2).permutation(gaps)


def drive(mix: dict, seed: int, seconds: float,
          serve: Callable[[int], float]) -> Tuple[List[Timing], float]:
    """Serve requests 0, 1, ... through `serve(k)`, which returns the
    request's own seconds, for a window of `seconds`. Returns their times
    and the window's length.

    Closed loop: the window is the requests' own seconds end to end (the
    harness's bookkeeping between them left out) and ends with the first
    request that finishes after `seconds`. Open loop: the window runs on
    the clock from the first arrival and ends when every request that
    arrived within `seconds` has finished; a request waits while an
    earlier one is served."""
    out: List[Timing] = []
    if mix["loop"] == "closed":
        busy = 0.0
        while not out or busy < seconds:
            took = serve(len(out))
            out.append(Timing(busy, busy, busy + took))
            busy += took
        return out, busy
    gaps = arrival_gaps(mix, seed, seconds)
    t0 = time.perf_counter()
    arrival = 0.0
    while not out or arrival < seconds:
        wait = arrival - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        start = time.perf_counter() - t0
        took = serve(len(out))
        out.append(Timing(arrival, start, start + took))
        arrival += float(gaps[(len(out) - 1) % len(gaps)])
    return out, max(t.finish for t in out)


def _rng(seed: int, k: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, k - WARMUP, stream])


def photo(mix: dict, res: int, seed: int, k: int = 0) -> dict:
    """A box foreground in front of a sloped background depth, and a
    seeded random image, NCHW numpy: img [1,3,res,res] in [0, 1], depth
    and bg_depth [1,1,res,res], fg_mask [1,1,res,res] in {0, 1}."""
    p = mix["photo"]
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    rows = yy * (p["depth_rows_ref"] / res)
    bg = (p["depth_near"] + p["depth_slope_per_row"] * rows).astype(
        np.float32)
    lo, hi = (int(round(f * res)) for f in p["fg_box"])
    fg = (yy >= lo) & (yy < hi) & (xx >= lo) & (xx < hi)
    depth = bg.copy()
    depth[fg] -= p["fg_offset"]
    index = k if mix.get("new_photo_each_request") else 0
    img = _rng(seed, index, 0).random((1, 3, res, res), dtype=np.float32)
    return dict(img=img, depth=depth[None, None], bg_depth=bg[None, None],
                fg_mask=fg.astype(np.float32)[None, None])


def transforms(mix: dict, seed: int, k: int) -> list:
    """Request k's transforms ("batch" of them), each a dict with
    rotation_angle (degrees), rotation_axis and translation."""
    if "rotation_deg" not in mix:
        return []
    rng = _rng(seed, k, 1)
    out = []
    for _ in range(mix["batch"]):
        angle = float(rng.uniform(*mix["rotation_deg"]))
        shift = [float(rng.uniform(lo, hi)) if hi > lo else float(lo)
                 for lo, hi in mix["translation"]]
        out.append(dict(rotation_angle=angle,
                        rotation_axis=list(mix["rotation_axis"]),
                        translation=shift))
    return out


def request(mix: dict, res: int, seed: int, k: int) -> dict:
    """Request k's inputs: its photo and its transforms."""
    return dict(photo=photo(mix, res, seed, k),
                transforms=transforms(mix, seed, k))


def sample_indices(n: int, count: int, seed: int, stream: int,
                   keep=()) -> list:
    """`count` distinct indices of range(n) drawn from the seed, always
    holding those in `keep`, sorted."""
    keep = sorted({i % n for i in keep}) if n else []
    rest = [i for i in range(n) if i not in keep]
    take = max(0, min(count - len(keep), len(rest)))
    rng = np.random.default_rng([int(seed) % 2 ** 64, 7, stream])
    picked = rng.choice(len(rest), size=take, replace=False) if take else []
    return sorted(keep + [rest[int(i)] for i in picked])
