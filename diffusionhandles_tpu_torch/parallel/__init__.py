"""Batched editing (`parallel/batch.py`) and its multi-GPU runtime: the
process group (`distributed.py`), the ('data', 'model') mesh (`mesh.py`)
and the U-Net's tensor parallelism (`sharding.py`)."""

from diffusionhandles_tpu_torch.parallel.mesh import make_mesh
from diffusionhandles_tpu_torch.parallel.sharding import (shard_params,
                                                          unet_param_spec)
