"""Training launcher.

Port of ``repro/launch/train.py``: runs a real (allocating) training job
for a ported architecture, at its published width (``--scale 1``, on the
card) or at a reduced width/depth factor (``scaled_config``, the
CPU-runnable path).  The launcher owns the data pipeline, the optimizer
and the trainer (checkpoint/restart + straggler monitor).  The reference's
mesh and sharding rules are a single card's here; ``--device`` (default
``cuda``; it raises without a card) picks the device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --scale 0.05 --steps 50 --batch 8 --seq 128 --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --scale 0.04 --steps 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.data import SyntheticLM, batch_spec_for
from repro_torch.models import config as C
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import Trainer, TrainerConfig


def scaled_config(cfg, scale: float):
    """Reduced config of the same family for CPU-scale runs."""
    if scale >= 1.0:
        return cfg
    d = max(64, int(cfg.d_model * scale) // 16 * 16)
    heads = max(2, min(cfg.n_heads, d // 64))
    kv = max(1, min(cfg.n_kv_heads, heads))
    layers = max(2, int(cfg.n_layers * scale))
    if cfg.family == "hybrid":
        layers = max(cfg.attn_every, layers // cfg.attn_every * cfg.attn_every)
    if cfg.family == "ssm":
        layers = max(cfg.slstm_every,
                     layers // cfg.slstm_every * cfg.slstm_every)
    hd = 64 if cfg.uses_mla else d // heads
    sections = ()
    if cfg.mrope:
        half = hd // 2
        sections = (half - half // 4 - half // 4, half // 4, half // 4)
    return dataclasses.replace(
        cfg,
        name=cfg.name + f"-x{scale}",
        n_layers=layers,
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=None if not cfg.uses_mla else 64,
        mrope_sections=sections if cfg.mrope else cfg.mrope_sections,
        d_ff=max(128, int(cfg.d_ff * scale) // 16 * 16) if cfg.d_ff else 0,
        moe_d_ff=max(64, int(cfg.moe_d_ff * scale) // 16 * 16)
        if cfg.moe_d_ff else 0,
        vocab_size=min(cfg.vocab_size, 8192),
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2),
        kv_lora_rank=64 if cfg.kv_lora_rank else 0,
        q_lora_rank=96 if cfg.q_lora_rank else 0,
        rope_head_dim=16 if cfg.rope_head_dim else 0,
        v_head_dim=64 if cfg.v_head_dim else 0,
        encoder_layers=max(2, int(cfg.encoder_layers * scale))
        if cfg.encoder_layers else 0,
        frontend_len=min(cfg.frontend_len, 64),
        ssm_state=min(cfg.ssm_state, 32) if cfg.ssm_state else 0,
        ssm_head_dim=min(cfg.ssm_head_dim, 32),
        chunk_size=min(cfg.chunk_size, 64),
        attn_chunk=128,
        attn_chunked_above=10 ** 9,
        dtype="float32",
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=C.available())
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = scaled_config(C.get(args.arch), args.scale)
    spec = batch_spec_for(cfg, args.batch, args.seq)
    data = SyntheticLM(cfg, spec, seed=args.seed)
    opt = AdamW(learning_rate=warmup_cosine(
        args.lr, warmup=max(args.steps // 20, 5), total=args.steps))
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, accum=args.accum,
                         seed=args.seed)
    trainer = Trainer(cfg, opt, data, tcfg, device=args.device)
    _, _, history = trainer.run()
    final = history[-1]
    print(f"[train.py] done: {len(history)} steps, final loss "
          f"{final['loss']:.4f}, stragglers flagged: "
          f"{trainer.monitor.flagged}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
