"""Deterministic sharded data pipeline.

Port of ``repro/data/pipeline.py``.  Two sources behind one interface:

* ``SyntheticLM``: token batches drawn by numpy's PCG64 from
  ``SeedSequence([seed, step, shard])``; fully deterministic, O(1) skip to
  any step (the trainer's restart path relies on it).
* ``MemmapCorpus``: a flat binary token file (``np.memmap``) cropped at
  random starts drawn the same way, for "real data" runs.

The draws are the reference's numpy calls, copied as they are, so a batch
equals the reference's bit for bit.  Each shard builds only its local
slice of the global batch.  The audio-frame and vision-patch stubs
synthesize the modality encoder's output the same way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.nbody import resolve_device
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    batch: int                  # global batch size
    seq: int                    # token sequence length
    enc_len: int = 0            # audio: encoder frame count
    patch_len: int = 0          # vlm: patch count


def batch_spec_for(cfg: ArchConfig, batch: int, seq: int) -> BatchSpec:
    if cfg.family == "audio":
        return BatchSpec(batch, seq, enc_len=seq)
    if cfg.family == "vlm":
        f = min(cfg.frontend_len, seq // 2)
        return BatchSpec(batch, seq - f, patch_len=f)
    return BatchSpec(batch, seq)


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, shard]))


class SyntheticLM:
    """Deterministic synthetic LM batches; ``shard``/``num_shards`` select the
    local slice of the global batch."""

    def __init__(self, cfg: ArchConfig, spec: BatchSpec, *, seed: int = 0,
                 shard: int = 0, num_shards: int = 1):
        if spec.batch % num_shards:
            raise ValueError(f"batch {spec.batch} does not split into "
                             f"{num_shards} shards")
        self.cfg, self.spec, self.seed = cfg, spec, seed
        self.shard, self.num_shards = shard, num_shards
        self.local_batch = spec.batch // num_shards

    def __call__(self, step: int) -> dict:
        """Local numpy batch for ``step`` (O(1) in step: restart skip)."""
        rng = _rng(self.seed, step, self.shard)
        cfg, spec = self.cfg, self.spec
        b, s = self.local_batch, spec.seq
        toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1),
                            dtype=np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if spec.enc_len:
            out["frames"] = rng.standard_normal(
                (b, spec.enc_len, cfg.d_model)).astype(np.float32)
        if spec.patch_len:
            out["patches"] = rng.standard_normal(
                (b, spec.patch_len, cfg.d_model)).astype(np.float32)
        return out


class MemmapCorpus:
    """Flat token-id binary file; deterministic random crops per step."""

    def __init__(self, cfg: ArchConfig, spec: BatchSpec, path: str, *,
                 dtype=np.int32, seed: int = 0, shard: int = 0,
                 num_shards: int = 1):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        if self.data.size <= spec.seq + 1:
            raise ValueError(f"corpus of {self.data.size} tokens is shorter "
                             f"than seq + 2 = {spec.seq + 2}")
        self.cfg, self.spec, self.seed = cfg, spec, seed
        self.shard, self.num_shards = shard, num_shards
        self.local_batch = spec.batch // num_shards

    def __call__(self, step: int) -> dict:
        rng = _rng(self.seed, step, self.shard)
        s = self.spec.seq
        starts = rng.integers(0, self.data.size - s - 1,
                              size=self.local_batch)
        rows = np.stack([np.asarray(self.data[a: a + s + 1]) for a in starts])
        rows = rows.astype(np.int32) % self.cfg.vocab_size
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def to_device(batch: dict, device) -> dict:
    """A numpy batch as contiguous tensors on ``device``."""
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in batch.items()}


def global_batch(source, step: int, *, device="cuda") -> dict:
    """The (local) numpy batch of ``step``, placed on ``device`` (default
    ``cuda``; raises without a card).  The reference's per-key
    ``shardings`` are a mesh's: on one card every key lands whole."""
    return to_device(source(step), resolve_device(device))
