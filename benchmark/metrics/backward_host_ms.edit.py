"""Host milliseconds of the backward of one guidance iteration (the
energy's gradient to the latents through the U-Net): the mean duration of
the program's `guidance.backward` spans that the CPU profiler recorded
whole.

None where the program recorded no such span."""

from diffusionhandles_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "spans", None)
    ns = [s.end_ns - s.start_ns for s in (spans() if spans else ())
          if s.name == "guidance.backward" and s.profiled]
    return sum(ns) / len(ns) * 1e-6 if ns else None
