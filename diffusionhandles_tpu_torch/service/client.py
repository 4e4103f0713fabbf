"""HTTP clients for the microservices.

The counterpart of the JAX package's `service/client.py` (reference:
webapp/example_clients/*.py): synchronous helpers on urllib that call a
service of either package and block until it answers. A transport error
or a timeout is retried with exponential backoff; an answer that reports
a failed handler is raised at once, since a retry would run the failed
computation again.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Optional

import numpy as np

from diffusionhandles_tpu_torch.service.base import (decode_payload,
                                                     encode_payload)


class ServiceClient:
    """`last_call` holds the request and response body bytes, the
    attempts and the seconds of the latest successful call."""

    def __init__(self, url: str, timeout: Optional[float] = 600.0,
                 retries: int = 2, retry_backoff: float = 1.0):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.retries = retries
        self.retry_backoff = retry_backoff
        self.last_call: Optional[dict] = None

    def call(self, endpoint: str, **payload):
        start = time.perf_counter()
        body = json.dumps(encode_payload(payload)).encode()
        last_exc = None
        for attempt in range(self.retries + 1):
            try:
                req = urllib.request.Request(
                    f"{self.url}/{endpoint}", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as resp:
                    raw = resp.read()
                out = json.loads(raw)
                if not out.get("ok", False):
                    # application error: don't retry, surface it
                    raise RuntimeError(
                        f"{endpoint} failed: {out.get('error')}\n"
                        f"{out.get('traceback', '')}")
                data = decode_payload(out["data"])
                self.last_call = {
                    "request_bytes": len(body),
                    "response_bytes": len(raw), "attempts": attempt + 1,
                    "seconds": time.perf_counter() - start}
                return data
            except urllib.error.HTTPError as exc:
                # the server answered with an error status (a failed
                # handler's body holds {"ok": false, "error",
                # "traceback"}): surface it instead of retrying
                try:
                    detail = json.loads(exc.read())
                    raise RuntimeError(
                        f"{endpoint} failed: {detail.get('error')}\n"
                        f"{detail.get('traceback', '')}") from None
                except (ValueError, KeyError, AttributeError):
                    raise RuntimeError(
                        f"{endpoint} failed: HTTP {exc.code}") from None
            except (urllib.error.URLError, ConnectionError,
                    TimeoutError) as exc:  # transport errors: retry
                last_exc = exc
                if attempt < self.retries:
                    time.sleep(self.retry_backoff * (2 ** attempt))
        raise ConnectionError(
            f"{self.url}/{endpoint} unreachable after "
            f"{self.retries + 1} attempts: {last_exc}")

    def wait_healthy(self, timeout: float = 60.0,
                     poll: float = 0.5) -> bool:
        """Block until the service's /health endpoint answers."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                out = self.call("health")
                if out.get("status") == "ok":
                    return True
            except (RuntimeError, ConnectionError, ValueError):
                pass
            time.sleep(poll)
        return False


class DepthEstimatorClient(ServiceClient):
    def estimate_depth(self, img: np.ndarray) -> np.ndarray:
        return self.call("estimate_depth", img=img)["depth"]


class ForegroundRemoverClient(ServiceClient):
    def remove_foreground(self, img, fg_mask, dilation: int = 3):
        return self.call("remove_foreground", img=img, fg_mask=fg_mask,
                         dilation=dilation)["bg_img"]


class ForegroundSelectorClient(ServiceClient):
    def select_foreground(self, img, prompt: str):
        return self.call("select_foreground", img=img,
                         prompt=prompt)["fg_mask"]


class Text2ImgClient(ServiceClient):
    def generate(self, prompt: str, seed: int = 0):
        return self.call("generate", prompt=prompt, seed=seed)["img"]


class DiffhandlesClient(ServiceClient):
    """Client for the core service
    (reference: example_clients/diffhandles_client.py)."""

    def set_input_image(self, img, depth, prompt: str) -> bytes:
        return self.call("set_input_image", img=img, depth=depth,
                         prompt=prompt)["input_image_identity"]

    def set_foreground(self, depth, fg_mask, bg_depth,
                       export_meshes: bool = False):
        return self.call("set_foreground", depth=depth, fg_mask=fg_mask,
                         bg_depth=bg_depth, export_meshes=export_meshes)

    def transform_foreground(self, identity: bytes, depth, prompt, fg_mask,
                             bg_depth, rot_angle=0.0,
                             rot_axis=(0.0, 1.0, 0.0),
                             translation=(0.0, 0.0, 0.0),
                             fg_weight=None, bg_weight=None):
        return self.call(
            "transform_foreground", input_image_identity=identity,
            depth=depth, prompt=prompt, fg_mask=fg_mask, bg_depth=bg_depth,
            rot_angle=rot_angle, rot_axis=list(rot_axis),
            translation=list(translation), fg_weight=fg_weight,
            bg_weight=bg_weight)

    def edit_image(self, img, depth, prompt, fg_mask, bg_depth,
                   rot_angle=0.0, rot_axis=(0.0, 1.0, 0.0),
                   translation=(0.0, 0.0, 0.0)):
        """One-call full edit (reference: diffhandles_client.py:12-33)."""
        identity = self.set_input_image(img, depth, prompt)
        bg = self.set_foreground(depth, fg_mask,
                                 bg_depth)["bg_depth_harmonized"]
        return self.transform_foreground(
            identity, depth, prompt, fg_mask, bg, rot_angle, rot_axis,
            translation)["edited_img"]
