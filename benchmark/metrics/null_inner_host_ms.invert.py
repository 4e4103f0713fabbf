"""Host milliseconds of one null-text inner step (U-Net forward, loss,
backward to the text context, Adam step, and the loss read back for the
early stop): the mean duration of the program's `null_text.inner` spans
that the CPU profiler recorded whole. The step in which the profiler
stops runs on past the traced calls, through the profiler's own stop, and
is left out.

None where the program recorded no such span."""

from diffusionhandles_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "spans", None)
    ns = [s.end_ns - s.start_ns for s in (spans() if spans else ())
          if s.name == "null_text.inner" and s.profiled]
    return sum(ns) / len(ns) * 1e-6 if ns else None
