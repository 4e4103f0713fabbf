"""Device time of the layout transposes (kernels.json
"layout_copy_patterns": cuDNN's NCHW <-> NHWC kernels) over all device
time in the traced calls, in percent.

None where the run has nothing to read."""


def read(run):
    d = run.digest
    if d is None or d.device_s <= 0 or d.layout_copy_s <= 0:
        return None
    return 100.0 * d.layout_copy_s / d.device_s
