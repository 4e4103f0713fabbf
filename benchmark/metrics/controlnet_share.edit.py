"""Share of the device time of an edit's traced calls that ran work the
ControlNet's forward launched: device operations launched inside the
program's `controlnet` spans (`trace_spans.py`) over all device
operations of the traced calls, in percent. Forward only: the backward
of a guidance call runs on autograd's thread, outside any span.

None where the program recorded no `controlnet` span (a family without a
ControlNet) or the run was not traced."""

from benchmark import trace_spans


def read(run):
    return trace_spans.share("controlnet") if run.digest else None
