from diffusionhandles_tpu_torch.service.base import (Webapp, decode_payload,
                                                     encode_payload)
from diffusionhandles_tpu_torch.service.job_manager import Job, JobManager
