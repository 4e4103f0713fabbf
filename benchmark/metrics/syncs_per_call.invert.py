"""Host waits for the device per U-Net call in the traced calls of an
inversion (the null-text loop's loss reads among them): the program's
`sync.<site>` spans over its `unet` spans.

None where the program recorded no `unet` span."""

from benchmark.harness import load_reader

read = load_reader("syncs_per_call.edit")
