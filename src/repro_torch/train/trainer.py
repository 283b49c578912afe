"""Training loop with checkpoint/restart, straggler monitoring and
deterministic data skip-ahead.

Port of ``repro/train/trainer.py``:

* **checkpoint/restart**: atomic checkpoints every ``ckpt_every`` steps
  (params + optimizer state + step counter) through
  ``repro_torch.checkpoint.store``, as the tree ``{"params", "opt"}`` with
  the reference's leaf names and dtypes, so a checkpoint either package
  writes resumes in the other.  On start the trainer resumes from the
  newest complete checkpoint and the counter-based data pipeline skips
  ahead in O(1).
* **straggler mitigation**: per-step wall time is tracked with an EWMA of
  mean and variance; a step slower than ``mean + k*sigma`` is flagged and
  logged.

A step's time is taken on the host clock after ``torch.cuda.synchronize``
(the reference's ``block_until_ready``).  ``init_state`` draws the
parameters with the port's ``init_params`` from
``torch.Generator(device).manual_seed(tcfg.seed)``: the reference's law,
not its bits; to start from the reference's parameters, pass them to
``run(start_params=..., start_opt=...)``.

``rules`` (keyword; the single-device rules by default) trains on a real
device mesh, one process per device (``distributed.process_mesh.spawn``):
the parameters are drawn whole and placed per ``params.param_shardings``,
the AdamW moments take their placements, and a restore places every leaf
per the *current* mesh (the reference's ``trainer.py:91-108``), so a run
saved on one device count resumes on another.  Every rank builds each
step's batch whole from the seed and places it per ``batch_shardings``
(``{name: NamedSharding}``, as ``train.step.batch_shardings`` gives them; a name
without one is placed on "batch" by the model), as ``jax.device_put``
does.  Only rank 0 logs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import store
from repro_torch.core.nbody import resolve_device
from repro_torch.data.pipeline import to_device
from repro_torch.distributed.shardings import MeshRules
from repro_torch.models import params as P
from repro_torch.models.config import ArchConfig
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time monitor; flags outliers > mean + k*sigma."""

    alpha: float = 0.1
    k: float = 3.0
    warmup: int = 5
    mean: float = 0.0
    var: float = 0.0
    count: int = 0
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        self.count += 1
        if self.count <= self.warmup:
            # prime the statistics without flagging (first steps warm up)
            self.mean = dt if self.count == 1 else (
                self.mean + (dt - self.mean) / self.count)
            self.var = max(self.var, (dt - self.mean) ** 2)
            return False
        slow = dt > self.mean + self.k * max(self.var, 1e-12) ** 0.5
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        if slow:
            self.flagged += 1
        return slow


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    accum: int = 1
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ArchConfig, opt: AdamW,
                 data: Callable[[int], dict], tcfg: TrainerConfig,
                 *, device="cuda", log: Callable[[str], None] = print,
                 rules: Optional[MeshRules] = None,
                 batch_shardings: Optional[dict] = None):
        self.cfg, self.opt = cfg, opt
        self.data, self.tcfg = data, tcfg
        self.rules = rules or MeshRules.single_device()
        self.batch_shardings = batch_shardings or {}
        self.device = resolve_device(device)
        self.monitor = StragglerMonitor()
        self._step_fn = make_train_step(cfg, opt, rules=self.rules,
                                        accum=tcfg.accum)
        lead = not self.rules.is_real or dist.get_rank() == 0
        self.log = log if lead else (lambda _msg: None)

    # ---------------- state ----------------
    def init_state(self):
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        params = P.init_params(self.cfg, gen, device=self.device,
                               rules=self.rules)
        return params, self.opt.init(params)

    def _shardings(self):
        """The current mesh's layout of ``{"params", "opt"}``: each moment
        placed as its parameter; None without a real mesh."""
        if not self.rules.is_real:
            return None
        sh = P.param_shardings(self.cfg, self.rules)
        return {"params": sh, "opt": AdamWState(count=None, m=sh, v=sh)}

    def restore_or_init(self):
        params, opt_state = self.init_state()
        if self.tcfg.ckpt_dir:
            step, tree = store.restore_latest(
                self.tcfg.ckpt_dir, {"params": params, "opt": opt_state},
                shardings=self._shardings())
            if step is not None:
                self.log(f"[trainer] restored checkpoint at step {step}")
                return step, tree["params"], tree["opt"]
        return 0, params, opt_state

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _save(self, step, params, opt_state):
        store.save(self.tcfg.ckpt_dir, step,
                   {"params": params, "opt": opt_state},
                   keep=self.tcfg.ckpt_keep)

    # ---------------- loop ----------------
    def run(self, *, start_params=None, start_opt=None, start_step=0):
        """Train to ``tcfg.steps``; returns (params, opt_state, history).
        ``start_params``/``start_opt`` (on this trainer's device) skip the
        restore; the parameters and moments are updated in place."""
        if start_params is None:
            start_step, params, opt_state = self.restore_or_init()
        else:
            params, opt_state = start_params, start_opt
        history = []
        for step in range(start_step, self.tcfg.steps):
            batch = to_device(self.data(step), self.device)
            batch = {k: sh.place(v) if (sh := self.batch_shardings.get(k))
                     else v for k, v in batch.items()}
            self._sync()
            t0 = time.perf_counter()
            params, opt_state, metrics = self._step_fn(
                params, opt_state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            slow = self.monitor.observe(dt)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics.update(step=step, step_time=dt, straggler=bool(slow))
            history.append(metrics)
            if slow:
                self.log(f"[straggler] step {step} took {dt*1e3:.1f} ms "
                         f"(mean {self.monitor.mean*1e3:.1f} ms)")
            if step % self.tcfg.log_every == 0:
                self.log(f"[train] step {step} loss {metrics['loss']:.4f} "
                         f"({dt*1e3:.1f} ms)")
            if self.tcfg.ckpt_dir and (step + 1) % self.tcfg.ckpt_every == 0:
                self._save(step + 1, params, opt_state)
        if self.tcfg.ckpt_dir:
            self._save(self.tcfg.steps, params, opt_state)
        return params, opt_state, history
