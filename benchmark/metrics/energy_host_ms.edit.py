"""Host milliseconds of the guidance losses of one guidance iteration:
the mean duration of the program's `guidance.energy` spans (the six loss
terms after the U-Net's forward) that the CPU profiler recorded whole.

None where the program recorded no such span."""

from diffusionhandles_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "spans", None)
    ns = [s.end_ns - s.start_ns for s in (spans() if spans else ())
          if s.name == "guidance.energy" and s.profiled]
    return sum(ns) / len(ns) * 1e-6 if ns else None
