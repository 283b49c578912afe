"""Serve an LM with batched requests: prefill a batch of prompts, then
lock-step decode.

Port of ``examples/serve_lm.py``, with the same flags, plus ``--device``
(default ``cuda``; it raises without a card) and ``--attn-impl`` (default
``flash``: each layer's prefill attention launches the flash kernel on the
card).  ``--scale`` defaults to 1.0, the model's published width.  The
weights are random, drawn from a seeded generator.  ``--arch`` takes every
ported config.  As in the reference, the prompts are tokens only: a vlm
config serves them as text (M-RoPE over text positions), and an audio
config raises ``KeyError`` for want of the frames its encoder runs on;
deepseek-v2 (MLA) serves with ``--attn-impl xla`` only.  The ssm and
hybrid configs (xlstm-1.3b, zamba2-7b) scan prompts in chunks of
min(chunk_size, prompt length), which must divide the prompt length (a
``ValueError`` says so); their fp32 leaves stay fp32.

  PYTHONPATH=src python -m repro_torch.launch.serve_lm --batch 4 \
      --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch zamba2-7b \
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --scale 0.04 \
      --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from repro_torch.core.nbody import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.train import scaled_config
from repro_torch.models import config as C
from repro_torch.models import params as P
from repro_torch.serve.engine import Engine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=C.available())
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--attn-impl", default="flash", choices=("flash", "xla"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(scaled_config(C.get(args.arch), args.scale),
                              attn_impl=args.attn_impl)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = P.init_params(cfg, gen, device=dev)
    print(f"[serve_lm] {cfg.name}: {P.count_params(cfg) / 1e6:.1f}M params, "
          f"batch={args.batch}, device={dev}, attn_impl={cfg.attn_impl}")

    engine = Engine(cfg, params, ServeConfig(
        max_len=args.prompt_len + args.gen, temperature=args.temperature))
    del params

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    launches = flash_attention.launches
    out, stats = engine.generate({"tokens": prompts}, args.gen)
    print(f"[serve_lm] prefill {stats['prefill_s'] * 1e3:.1f} ms, "
          f"decode {stats['decode_s'] * 1e3:.1f} ms "
          f"({stats['tok_per_s']:.1f} tok/s), flash kernel launches "
          f"{flash_attention.launches - launches}")
    for i in range(min(2, args.batch)):
        print(f"  seq {i}: {out[i, :16].tolist()} ...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
