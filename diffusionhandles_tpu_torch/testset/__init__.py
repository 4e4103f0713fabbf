"""The test-set path: preprocessing, the batch driver over photogen
manifests, its metrics and the HTML gallery."""

from diffusionhandles_tpu_torch.testset.driver import test_diffusion_handles
from diffusionhandles_tpu_torch.testset.report import (
    generate_results_webpage, psnr)
