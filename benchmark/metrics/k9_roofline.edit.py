"""K9 (fused GroupNorm+SiLU+conv3x3, forward and dx together): its share
of its roofline, with counting.gn_silu_conv3x3_fwd and _dx, in percent."""

from benchmark.readers import roofline

read = roofline("K9")
