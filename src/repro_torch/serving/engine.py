"""Serving engine: batched prefill + decode against a KV cache or a
recurrent state, as ``repro.serving.engine`` has it.

The engine owns one cache buffer, made once at the constructor's batch,
``max_len`` and, for an encoder-decoder model, ``enc_len`` (``max_len`` by
default; it sizes the cache's ``enc_out`` entry, as the JAX engine's, and
the frames may be longer or shorter); prefill and every decode step write
into it in place, and ``generate`` clears it before it returns, so the
shapes never change between requests.  Every entry of the request's
batch goes to the bundle's prefill, moved to the engine's device: the
tokens as int64, the rest (``inputs_embeds``, an enc-dec model's
``frames``) in their own dtype.  Greedy decoding (``temperature <= 0``)
takes the argmax of the logits; sampling draws from a ``torch.Generator``
seeded from ``seed`` (not JAX's stream).  ``prefill_s`` and ``decode_s``
are wall times that end in a device synchronisation.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..kernels import resolve_device
from ..models.registry import ModelBundle
from ..store.convert import tensor_from_numpy
from ..tree import tree_leaves


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, n_generated) int32
    prefill_s: float
    decode_s: float
    steps: int


class ServeEngine:
    def __init__(
        self,
        bundle: ModelBundle,
        params: Any,
        *,
        max_len: int,
        batch: int,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        enc_len: Optional[int] = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.params = params
        self.max_len = max_len
        self.batch = batch
        self.temperature = temperature
        self.eos_id = eos_id
        kw = {"enc_len": enc_len} if self.cfg.is_encdec else {}
        self._cache0 = bundle.init_cache(batch, max_len, device=self.device, **kw)

    def _on_device(self, x: Any) -> torch.Tensor:
        """A batch entry as a tensor on the engine's device, in its dtype (a
        numpy bfloat16 array, ml_dtypes', as torch's)."""
        t = x if isinstance(x, torch.Tensor) else tensor_from_numpy(np.asarray(x))
        return t.to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
        logits = logits[:, -1, : self.cfg.vocab].float()
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)[:, None]
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    @torch.no_grad()
    def generate(
        self,
        batch: Dict[str, Any],
        *,
        max_new_tokens: int,
        seed: int = 0,
    ) -> GenerationResult:
        inputs = {k: self._on_device(v) for k, v in batch.items()}
        tokens = inputs["tokens"] = inputs["tokens"].to(torch.int64)
        B, prompt_len = tokens.shape
        if B != self.batch or prompt_len + max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"a batch of {B} prompts of {prompt_len} tokens and "
                f"{max_new_tokens} new tokens do not fit the engine's batch "
                f"{self.batch} and max_len {self.max_len}")
        gen = None
        if self.temperature > 0:
            gen = torch.Generator(device=self.device).manual_seed(seed)

        self._sync()
        t0 = time.monotonic()
        logits, cache = self.bundle.prefill(self.params, inputs, self._cache0)
        tok = self._sample(logits, gen)
        self._sync()
        prefill_s = time.monotonic() - t0

        out = [tok]
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        t0 = time.monotonic()
        steps = 0
        for i in range(max_new_tokens - 1):
            logits, cache = self.bundle.decode_step(self.params, tok, cache, prompt_len + i)
            tok = self._sample(logits, gen)
            out.append(tok)
            steps += 1
            if self.eos_id is not None:
                done |= tok[:, 0] == self.eos_id
                if bool(done.all()):
                    break
        self._sync()
        decode_s = time.monotonic() - t0
        for t in tree_leaves(self._cache0):
            t.zero_()
        return GenerationResult(
            tokens=torch.cat(out, dim=1).to(torch.int32).cpu().numpy(),
            prefill_s=prefill_s,
            decode_s=decode_s,
            steps=steps + 1,
        )
