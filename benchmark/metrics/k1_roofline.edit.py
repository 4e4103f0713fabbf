"""K1 (flash-attention forward): its share of its roofline, with
counting.attention_fwd, in percent."""

from benchmark.readers import roofline

read = roofline("K1")
