"""Object-peeling foreground remover (remote REST client).

The counterpart of the JAX package's `service/object_peeling.py`
(reference: webapp/webapps/object_peeling_webapp.py:20-79, an alternative
to LaMa backed by a remote REST inpainting endpoint): a JSON POST
{img, fg_mask} -> {bg_img} in the services' codec. Without an endpoint it
raises and names the local LamaInpainter.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Optional

import numpy as np
import torch

from diffusionhandles_tpu_torch.models.lama import ForegroundRemover
from diffusionhandles_tpu_torch.ops.morphology import binary_dilation_iter
from diffusionhandles_tpu_torch.service.base import (decode_payload,
                                                     encode_payload)


class ObjectPeelingRemover(ForegroundRemover):
    def __init__(self, endpoint_url: Optional[str] = None,
                 timeout: float = 120.0):
        self.endpoint_url = endpoint_url
        self.timeout = timeout

    def remove_foreground(self, img: np.ndarray, fg_mask: np.ndarray,
                          dilation: int = 0) -> np.ndarray:
        if self.endpoint_url is None:
            raise RuntimeError(
                "ObjectPeelingRemover needs endpoint_url (remote REST "
                "service); use LamaInpainter for local inpainting")
        if dilation > 0:
            m = binary_dilation_iter(torch.from_numpy(
                np.asarray(fg_mask).reshape(img.shape[-2:]) > 0.5),
                dilation).numpy().astype(np.float32)
            fg_mask = m[None, None]
        body = json.dumps(encode_payload(
            {"img": np.asarray(img, np.float32),
             "fg_mask": np.asarray(fg_mask, np.float32)})).encode()
        req = urllib.request.Request(
            self.endpoint_url, data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = decode_payload(json.loads(resp.read()))
        return np.asarray(out["bg_img"], np.float32)
