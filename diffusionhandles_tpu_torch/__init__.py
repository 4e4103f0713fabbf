"""diffusionhandles_tpu_torch: DiffusionHandles in PyTorch for NVIDIA Hopper.

The PyTorch/CUDA port of the JAX package: the same four-step editing
API (`DiffusionHandles`), module layout and numerics, with the JAX
package's Pallas kernels (flash attention; GroupNorm and the fused
GroupNorm+SiLU+conv3x3 of the fused U-Net config) rewritten as CUDA kernels
for the H100 (`csrc/`). Imports torch only; never jax. Entry points run on
the GPU unless given another device.
"""

from diffusionhandles_tpu_torch.config import (DiffusionHandlesConfig,
                                               load_config)

__all__ = ["DiffusionHandles", "DiffusionHandlesConfig", "load_config"]
__version__ = "0.1.0"


def __getattr__(name):
    # Lazy: `import diffusionhandles_tpu_torch` stays config-only.
    if name == "DiffusionHandles":
        from diffusionhandles_tpu_torch.pipeline import DiffusionHandles
        return DiffusionHandles
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
