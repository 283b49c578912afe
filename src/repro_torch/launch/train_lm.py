"""Train a reduced qwen3-family LM (about 10M or 100M parameters) for a few
hundred steps with the whole training path: AdamW + warmup-cosine, the
deterministic data pipeline, checkpoint/restart and the straggler monitor.

Port of ``examples/train_lm.py``, with its presets and flags, plus
``--device`` (default ``cuda``; it raises without a card).  Without
``--ckpt-dir`` no checkpoint is written; the reference writes to
``/tmp/repro_train_lm`` by default.

  PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 200 \\
      --preset 100m
  PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 3 \\
      --preset 10m --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.data import SyntheticLM, batch_spec_for
from repro_torch.models import config as C
from repro_torch.models import params as P
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import Trainer, TrainerConfig

PRESETS = {
    # ~104M params: 12L x 768, tied embeddings over the qwen3 vocab subset
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=2048, vocab_size=32768, batch=8, seq=256),
    "10m": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                d_ff=688, vocab_size=8192, batch=4, seq=128),
}


def preset_config(preset: str):
    p = PRESETS[preset]
    return dataclasses.replace(
        C.get("qwen3-0.6b"),
        name=f"qwen3-{preset}",
        n_layers=p["n_layers"], d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"], head_dim=p["d_model"] // p["n_heads"],
        dtype="float32", attn_chunked_above=10 ** 9, remat="none")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="10m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    p = PRESETS[args.preset]
    cfg = preset_config(args.preset)
    print(f"[train_lm] {cfg.name}: {P.count_params(cfg) / 1e6:.1f}M params")

    data = SyntheticLM(cfg, batch_spec_for(cfg, p["batch"], p["seq"]))
    opt = AdamW(learning_rate=warmup_cosine(
        args.lr, warmup=max(args.steps // 20, 5), total=args.steps))
    trainer = Trainer(cfg, opt, data,
                      TrainerConfig(steps=args.steps,
                                    ckpt_every=max(args.steps // 2, 25),
                                    ckpt_dir=args.ckpt_dir, log_every=10),
                      device=args.device)
    _, _, history = trainer.run()
    print(f"[train_lm] final loss {history[-1]['loss']:.4f} "
          f"(step time {history[-1]['step_time'] * 1e3:.0f} ms, "
          f"stragglers {trainer.monitor.flagged})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
