"""K2 (flash-attention backward): its share of its roofline, with
counting.attention_bwd, in percent."""

from benchmark.readers import roofline

read = roofline("K2")
