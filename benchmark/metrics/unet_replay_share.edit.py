"""Share of the process's U-Net calls that replayed CUDA graphs, in
percent: `replay` over all calls of the program's
`models.unet.GRAPH_CALLS` (eager, capture, replay), set-up, window and
traced calls together.

None where the program keeps no such counter."""

import importlib


def read(run):
    unet = importlib.import_module("diffusionhandles_tpu_torch.models.unet")
    calls = getattr(unet, "GRAPH_CALLS", None)
    total = sum(calls.values()) if calls else 0
    return 100.0 * calls["replay"] / total if total else None
