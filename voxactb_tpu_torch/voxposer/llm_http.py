"""Production LLM transport: OpenAI-compatible HTTP backends with retry.

Counterpart of the reference's OpenAI clients: the LMP completion call with
retry/sleep (peract/voxposer/LMP.py:70-117, retry :100-105) and the GPT-4V
dominant-hand helper (voxposer/envs/rlbench_env.py:617-688). Implemented over
stdlib ``urllib`` so nothing new is vendored; any OpenAI-compatible server works
(set ``VOXACTB_LLM_BASE_URL`` to point at a local/proxy endpoint). Both backends
plug into the :class:`~voxactb_tpu_torch.voxposer.lmp.LLMBackend` protocol, so LMPs are
transport-agnostic — tests drive them against an in-process fake HTTP server.

A copy of ``voxactb_tpu.voxposer.llm_http``, kept in the port so that it imports nothing
of the JAX package; host code, the same on every device.
"""

from __future__ import annotations

import base64
import io
import json
import os
import time
import urllib.error
import urllib.request
from typing import List, Optional, Sequence

import numpy as np

DEFAULT_BASE_URL = "https://api.openai.com/v1"


class LLMTransportError(RuntimeError):
    pass


def _post_json(url: str, payload: dict, api_key: str, timeout: float) -> dict:
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode("utf-8"),
        headers={
            "Content-Type": "application/json",
            "Authorization": f"Bearer {api_key}",
        },
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


class OpenAIChatBackend:
    """Chat-completions client implementing the ``LLMBackend`` protocol.

    Retries failed calls with a sleep between attempts (the reference's
    try/sleep(5)/retry loop, LMP.py:100-105) and raises ``LLMTransportError``
    after the budget is exhausted. The API key comes from ``api_key`` or the
    ``OPENAI_API_KEY`` env var; construction fails fast without one so a
    misconfigured eval run dies before booting the simulator.
    """

    def __init__(self, model: str = "gpt-4", base_url: Optional[str] = None,
                 api_key: Optional[str] = None, temperature: float = 0.0,
                 max_tokens: int = 512, max_retries: int = 3,
                 retry_sleep_s: float = 5.0, timeout_s: float = 60.0,
                 _sleep=time.sleep):
        self.model = model
        self.base_url = (base_url or os.environ.get("VOXACTB_LLM_BASE_URL")
                         or DEFAULT_BASE_URL).rstrip("/")
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        if not self.api_key:
            raise LLMTransportError(
                "no API key: pass api_key= or set OPENAI_API_KEY")
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.max_retries = max_retries
        self.retry_sleep_s = retry_sleep_s
        self.timeout_s = timeout_s
        self._sleep = _sleep
        self.n_requests = 0

    def _chat(self, messages: List[dict], stop: Optional[Sequence[str]]) -> str:
        payload = {
            "model": self.model,
            "messages": messages,
            "temperature": self.temperature,
            "max_tokens": self.max_tokens,
        }
        if stop:
            payload["stop"] = list(stop)[:4]  # API cap
        last_err: Optional[Exception] = None
        for attempt in range(self.max_retries):
            try:
                self.n_requests += 1
                out = _post_json(f"{self.base_url}/chat/completions", payload,
                                 self.api_key, self.timeout_s)
                return out["choices"][0]["message"]["content"]
            except Exception as e:  # network / HTTP / schema errors all retry
                last_err = e
                if attempt < self.max_retries - 1:
                    self._sleep(self.retry_sleep_s)
        raise LLMTransportError(
            f"chat completion failed after {self.max_retries} attempts: "
            f"{last_err}")

    # -- LLMBackend protocol -------------------------------------------------------

    def __call__(self, prompt: str, stop: list) -> str:
        return self._chat(
            [{"role": "user", "content": prompt}], stop)


def _encode_jpeg_b64(rgb: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(rgb, np.uint8)).save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode("utf-8")


class VisionChatBackend(OpenAIChatBackend):
    """GPT-4V-style image+text completion (rlbench_env.py:617-688)."""

    def __init__(self, model: str = "gpt-4-vision-preview", **kw):
        super().__init__(model=model, **kw)
        self._image_cache: dict = {}

    def ask_about_image(self, rgb: np.ndarray, prompt: str) -> str:
        b64 = _encode_jpeg_b64(rgb)
        key = (prompt, hash(b64))
        if key in self._image_cache:
            return self._image_cache[key]
        content = self._chat(
            [{
                "role": "user",
                "content": [
                    {"type": "text", "text": prompt},
                    {"type": "image_url",
                     "image_url": {"url": f"data:image/jpeg;base64,{b64}"}},
                ],
            }],
            stop=None,
        )
        self._image_cache[key] = content
        return content


def determine_dominant_hand_llm(rgb: np.ndarray, prompt: str,
                                backend: VisionChatBackend,
                                rng: Optional[np.random.Generator] = None
                                ) -> str:
    """Ask a vision LLM which arm should act; parse 'left'/'right' from the tail
    of the answer, falling back to a random assignment on gibberish — the
    reference's exact decision procedure (rlbench_env.py:670-683)."""
    try:
        content = backend.ask_about_image(rgb, prompt)
    except LLMTransportError:
        content = ""
    tail = ".".join(content.split(".")[-2:]).lower()
    if "left" in tail:
        return "left"
    if "right" in tail:
        return "right"
    rng = rng or np.random.default_rng()
    return "right" if rng.integers(2) == 0 else "left"
