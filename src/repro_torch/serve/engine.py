"""Batched serving engine: prefill + lock-step decode with a shared cache.

Port of ``repro/serve/engine.py`` (``ServeConfig`` and ``Engine.generate``).
Requests are aligned into one (B, S_prompt) block; ``generate`` prefills
it once and then advances every sequence one token per decode step.

The weights are cast once, when the engine is built (the inference
checkpoint cast): to ``cfg.dtype``, or to fp32 for the leaves that every
use casts to fp32 (``params.FP32_LEAVES``: the ssm and hybrid families'
recurrent weights); the reference casts them at every use, which gives
the same bits.  The cache (KV, or the recurrent state) is updated in
place, as the reference's donated cache is.

``rules`` (keyword; the single-device rules by default) serves on a real
device mesh, every family: the parameters are DTensors placed by
``params.param_shardings`` (the cast keeps each leaf's placements, the
fp32 leaves' too), the cache (KV, or the hybrid and ssm families'
recurrent states and conv cache) is placed by its logical axes and
updated in place, every rank runs the engine on the same prompts, and
sampling reads the logits gathered whole on every rank, so every rank
emits the same tokens.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.distributed.shardings import MeshRules, full
from repro_torch.models import model
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import cast_params


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 2048
    temperature: float = 0.0     # 0 => greedy
    seed: int = 0


class Engine:
    def __init__(self, cfg: ArchConfig, params: dict,
                 scfg: ServeConfig = ServeConfig(), *,
                 rules: MeshRules = model.SINGLE):
        self.cfg, self.scfg, self.rules = cfg, scfg, rules
        self.params = cast_params(params, cfg.dtype)
        self.device = self.params["embed"].device

    def _sample(self, logits, generator):
        """Greedy: the first maximum, as ``jnp.argmax``.  Temperature: a
        draw from ``generator``; it has the distribution of
        ``jax.random.categorical`` but not its bits."""
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.to(torch.float32) / self.scfg.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, batch: dict, n_tokens: int):
        """Greedy/temperature generation; returns (tokens (B, n), stats).

        ``batch`` holds the prompts' ``tokens`` and, for the vlm and audio
        families, the stub frontends' ``patches`` or ``frames``; every
        entry goes to ``model.prefill`` on the engine's device, as the
        reference passes the whole batch.

        The first token comes from the prefill logits and ``n_tokens``
        decode steps follow; the result holds the prefill token and leaves
        out the token sampled from the last step's logits, as the
        reference does.  Times are host-clock seconds, each phase ending in
        a device synchronise."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        t0 = time.perf_counter()
        logits, cache = model.prefill(self.cfg, self.params, batch,
                                      max_len=self.scfg.max_len,
                                      rules=self.rules)
        logits = full(logits)
        self._sync()
        t_prefill = time.perf_counter() - t0

        gen = torch.Generator(device=self.device).manual_seed(self.scfg.seed)
        toks = []
        nxt = self._sample(logits, gen)
        t0 = time.perf_counter()
        for _ in range(n_tokens):
            toks.append(nxt)
            logits, cache = model.decode_step(self.cfg, self.params, cache,
                                              nxt[:, None], rules=self.rules)
            nxt = self._sample(full(logits), gen)
        self._sync()
        t_decode = time.perf_counter() - t0
        out = torch.stack(toks, dim=1)
        b = out.shape[0]
        return out, {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tok_per_s": b * n_tokens / max(t_decode, 1e-9),
        }


def prefill_step(cfg: ArchConfig, *, rules: MeshRules = model.SINGLE):
    """Bare prefill ``fn(params, batch) -> (logits, cache)``, the
    reference's dry-run target; the tensors' device picks the route."""

    def step(params, batch):
        return model.prefill(cfg, params, batch, rules=rules)

    return step


def decode_step(cfg: ArchConfig, *, rules: MeshRules = model.SINGLE):
    """Bare decode ``fn(params, cache, tokens) -> (logits, cache)``: one new
    token per sequence against the cache."""

    def step(params, cache, tokens):
        return model.decode_step(cfg, params, cache, tokens, rules=rules)

    return step
