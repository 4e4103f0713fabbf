"""Share of the process's foreground guidance-term applications that ran
the card's kernel pair, in percent: `kernel` over all of the program's
`guidance.FG_LOSS_CALLS` (kernel, plain), set-up, window and traced
edits together.

None where the program keeps no such counter."""

import importlib


def read(run):
    guidance = importlib.import_module("diffusionhandles_tpu_torch.guidance")
    calls = getattr(guidance, "FG_LOSS_CALLS", None)
    total = sum(calls.values()) if calls else 0
    return 100.0 * calls["kernel"] / total if total else None
