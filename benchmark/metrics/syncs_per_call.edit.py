"""Host waits for the device per U-Net call in the traced calls of an
edit: the program's `sync.<site>` spans over its `unet` spans.

None where the program recorded no `unet` span."""

from diffusionhandles_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "spans", None)
    names = [s.name for s in (spans() if spans else ())]
    calls = names.count("unet")
    if not calls:
        return None
    return sum(n.startswith("sync.") for n in names) / calls
