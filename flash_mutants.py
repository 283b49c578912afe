#!/usr/bin/env python3
"""Planted faults in the bf16 flash-attention kernel (K3), held to the
checks that ``chip_smoke.py`` phase 6 holds the kernel to.

    python3 flash_mutants.py

Needs a card and ``nvcc``.  Each fault is a textual edit of the bf16
kernel in ``src/repro_torch/csrc/flash_attention.cu``, written to a
temporary directory and built there, one ``nvcc`` per fault, all started
together; the unedited source is built the same way.  For every build and
every bf16 case of phase 6 it prints the readings of
``chip_smoke.flash_readings``, the checks they fail, and whether the
former limit (max |kernel - plain| <= 3e-2 max |plain|) fails them too.
The last line is one JSON object with all readings.  Exits nonzero if the
unedited kernel fails a check or a fault marked ``must_fail`` passes them
all.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on sys.path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

#: the wrapper's library loader, before ``use`` replaces it
_LOAD_LIBRARY = fa._library.__wrapped__
#: the former bf16 limit of phase 6, as max |kernel - plain| / max |plain|
OLD_TOL = 3e-2

#: name -> (edits of the bf16 kernel as (old, new) pairs, must_fail)
FAULTS = {
    "unedited": ((), False),
    "l sums the rounded p": ((
        ("ls[0] += p0 + p1;\n      ls[1] += p2 + p3;",
         "ls[0] += __bfloat162float(__float2bfloat16(p0)) +\n"
         "               __bfloat162float(__float2bfloat16(p1));\n"
         "      ls[1] += __bfloat162float(__float2bfloat16(p2)) +\n"
         "               __bfloat162float(__float2bfloat16(p3));"),), True),
    "p rounded toward zero": ((
        ("const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);",
         "const __nv_bfloat162 v = __halves2bfloat162(\n"
         "      __float2bfloat16_rz(lo), __float2bfloat16_rz(hi));"),), True),
    "l not rescaled by alpha": ((
        ("l[i] = l[i] * alpha[i] + ls[i];", "l[i] = l[i] + ls[i];"),), True),
    "second row rescaled by the first row's alpha": ((
        ("o[4 * j + 2] *= alpha[1];\n          o[4 * j + 3] *= alpha[1];",
         "o[4 * j + 2] *= alpha[0];\n          o[4 * j + 3] *= alpha[0];"),),
        True),
    "diagonal tile dropped past the first tile": ((
        ("causal ? min(n_tiles, wg_last / kBf16Keys + 1)",
         "causal ? min(n_tiles, max(1, (wg_last + 1) / kBf16Keys))"),),
        True),
    # the pipeline: each tile is read from the previous stage's K/V buffer,
    # which holds the last tile or is being refilled with a later one
    "stage reads the previous stage's K/V buffer": ((
        ("const uint32_t ks = base + stage * 2 * L::kTileBytes;",
         "const uint32_t ks =\n"
         "        base + (stage + kStages - 1) % kStages * 2 * L::kTileBytes;"),
        ("const uint32_t vs = base + (t % kStages) * 2 * L::kTileBytes + L::kTileBytes;",
         "const uint32_t vs =\n"
         "        base + (t + kStages - 1) % kStages * 2 * L::kTileBytes + L::kTileBytes;"),),
        True),
}


def mutant_source(text: str, edits) -> str:
    """``text`` with each edit applied once inside the bf16 kernel."""
    cut = text.index("// fp32: scalar FMA kernel")
    bf16, rest = text[:cut], text[cut:]
    for old, new in edits:
        if bf16.count(old) != 1:
            raise RuntimeError(f"edit target not found once: {old!r}")
        bf16 = bf16.replace(old, new)
    return bf16 + rest


def build_all(workdir: Path) -> dict[str, Path]:
    text = (_build.CSRC / "flash_attention.cu").read_text()
    nvcc = _build.nvcc_path()
    procs = {}
    for i, (name, (edits, _)) in enumerate(FAULTS.items()):
        src = workdir / f"fault{i}.cu"
        src.write_text(mutant_source(text, edits))
        lib = workdir / f"libfault{i}.so"
        procs[name] = (subprocess.Popen(
            _build.nvcc_command(src, lib, nvcc), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        libs[name] = lib
    return libs


def use(lib_path: Path):
    """Route ``fa.flash_attention`` through the library at ``lib_path``."""
    load = _build.load
    _build.load = lambda name: ctypes.CDLL(str(lib_path))
    try:
        lib = _LOAD_LIBRARY()
    finally:
        _build.load = load
    fa._library = lambda: lib


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_mutants: no card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    cfg = cs.lm_config.get(cs.LM_ARCH)
    prefill = (cs.LM_BATCH, cs.LM_PROMPT, cs.LM_PROMPT, cfg.n_heads,
               cfg.n_kv_heads, cfg.head_dim)
    cases = [c for c in cs.flash_cases(prefill) if c[2] == torch.bfloat16]
    bad = []
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(Path(tmp))
        for name, lib in libs.items():
            use(lib)
            must_fail = FAULTS[name][1]
            caught, caught_old = [], False
            for label, (b, sq, sk, h, kvh, d), dtype, causal, (bq, bk) in cases:
                q, k, v = cs.flash_operands(b, sq, sk, h, kvh, d, dtype, dev,
                                            seed=sq + sk)
                try:
                    r = cs.flash_readings(q, k, v, causal, bq, bk)
                except RuntimeError as e:  # a non-finite or misshapen output
                    r, failed = {"error": str(e)}, [str(e)]
                    old = True
                else:
                    failed = cs.flash_failures(r, "bf16")
                    old = r["norm_err"] > OLD_TOL
                results[f"{name} | {label}"] = dict(r, failed=failed,
                                                    old_limit_fails=old)
                caught += failed
                caught_old |= old
                print(f"{name:<46} {label:<10} {json.dumps(r)} "
                      f"fails: {failed or 'none'}; former limit "
                      f"{'fails' if old else 'passes'}", flush=True)
            print(f"-> {name}: {'CAUGHT' if caught else 'passes every check'}"
                  f" (former limit: {'caught' if caught_old else 'missed'})",
                  flush=True)
            if name == "unedited" and caught:
                bad.append("the unedited kernel fails a check")
            if must_fail and not caught:
                bad.append(f"fault {name!r} passes every check")
    print(json.dumps({"card": card, "readings": results, "bad": bad}),
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
