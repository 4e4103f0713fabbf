"""The inversions' model FLOPs (the U-Net calls, the null-text backward
to the text context only, and the VAE encode) over the window's seconds
times the card's bf16 peak, in percent."""

from benchmark.readers import mfu as read  # noqa: F401
