"""Share of the process's U-Net calls that replayed CUDA graphs in an
inversion cell, in percent (as unet_replay_share.edit).

None where the program keeps no such counter."""

from benchmark.harness import load_reader

read = load_reader("unet_replay_share.edit")
