"""The edits' model FLOPs (every U-Net call of the window at its batch,
the guidance backward to the latents only, and the VAE decodes) over the
window's seconds times the card's bf16 peak, in percent."""

from benchmark.readers import mfu as read  # noqa: F401
