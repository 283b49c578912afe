#!/usr/bin/env python3
"""Planted faults in the flash-attention kernels (K3, bf16 and fp32), held
to the checks that ``chip_smoke.py`` phase 6 holds the kernels to.

    python3 flash_mutants.py

Needs a card and ``nvcc``.  Each fault is a textual edit of one kernel in
``src/repro_torch/csrc/flash_attention.cu`` (the bf16 kernel above the
``FP32_BANNER`` comment, the fp32 kernel and the launcher below it),
written to a temporary directory and built there, one ``nvcc`` per fault,
all started together; the unedited source is built the same way.  A fault
runs the phase-6 cases of its own kernel's type, the unedited source all of
them.  For every build and case it prints the readings of
``chip_smoke.flash_readings``, the checks they fail, and, for bf16, whether
the former limit (max |kernel - plain| <= 3e-2 max |plain|) fails them too.
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

#: where the fp32 kernel's section of the source begins
FP32_BANNER = "// fp32: 3xTF32 tensor-core kernel"

#: name -> (section, edits of that kernel as (old, new) pairs, must_fail)
FAULTS = {
    "unedited": ("bf16", (), False),
    "l sums the rounded p": ("bf16", (
        ("ls[0] += p0 + p1;\n      ls[1] += p2 + p3;",
         "ls[0] += __bfloat162float(__float2bfloat16(p0)) +\n"
         "               __bfloat162float(__float2bfloat16(p1));\n"
         "      ls[1] += __bfloat162float(__float2bfloat16(p2)) +\n"
         "               __bfloat162float(__float2bfloat16(p3));"),), True),
    "p rounded toward zero": ("bf16", (
        ("const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);",
         "const __nv_bfloat162 v = __halves2bfloat162(\n"
         "      __float2bfloat16_rz(lo), __float2bfloat16_rz(hi));"),), True),
    "l not rescaled by alpha": ("bf16", (
        ("l[i] = l[i] * alpha[i] + ls[i];", "l[i] = l[i] + ls[i];"),), True),
    "second row rescaled by the first row's alpha": ("bf16", (
        ("pv[4 * j + 2] *= alpha[1];\n          pv[4 * j + 3] *= alpha[1];",
         "pv[4 * j + 2] *= alpha[0];\n          pv[4 * j + 3] *= alpha[0];"),),
        True),
    "diagonal tile dropped past the first tile": ("bf16", (
        ("causal ? min(n_tiles, wg_last / kBf16Keys + 1)",
         "causal ? min(n_tiles, max(1, (wg_last + 1) / kBf16Keys))"),),
        True),
    # the pipeline: each tile is read from the previous stage's K/V buffer,
    # which holds the last tile or is being refilled with a later one
    "stage reads the previous stage's K/V buffer": ("bf16", (
        ("const uint32_t ks = base + stage * 2 * L::kTileBytes;",
         "const uint32_t ks =\n"
         "        base + (stage + kStages - 1) % kStages * 2 * L::kTileBytes;"),
        ("const uint32_t vs = base + (t % kStages) * 2 * L::kTileBytes + L::kTileBytes;",
         "const uint32_t vs =\n"
         "        base + (t + kStages - 1) % kStages * 2 * L::kTileBytes + L::kTileBytes;"),),
        True),
    # fp32: every product taken as hi.hi alone (1xTF32, 11 bits of 24)
    "1xTF32: the lo terms dropped": ("fp32", (
        ("  mma_tf32(d, al, bh0, bh1);\n  mma_tf32(d, ah, bl0, bl1);\n", ""),),
        True),
    # fp32: l sums the tf32-rounded p that P V's hi terms use
    "l sums p's rounded hi part": ("fp32", (
        ("      ls[0] += p0 + p1;\n      ls[1] += p2 + p3;\n"
         "      split(p0, ph[nt][0], pl[nt][0]);\n"
         "      split(p2, ph[nt][1], pl[nt][1]);\n"
         "      split(p1, ph[nt][2], pl[nt][2]);\n"
         "      split(p3, ph[nt][3], pl[nt][3]);\n",
         "      split(p0, ph[nt][0], pl[nt][0]);\n"
         "      split(p2, ph[nt][1], pl[nt][1]);\n"
         "      split(p1, ph[nt][2], pl[nt][2]);\n"
         "      split(p3, ph[nt][3], pl[nt][3]);\n"
         "      ls[0] += __uint_as_float(ph[nt][0]) + "
         "__uint_as_float(ph[nt][2]);\n"
         "      ls[1] += __uint_as_float(ph[nt][1]) + "
         "__uint_as_float(ph[nt][3]);\n"),),
        True),
    # fp32's double buffer: each tile is read from the other buffer, which
    # holds the tile before it or is being filled with the next one
    "tile read from the other buffer": ("fp32", (
        ("compute(t, kbuf + (t & 1) * L::kTile, vbuf + (t & 1) * L::kTile);",
         "compute(t, kbuf + ((t + 1) & 1) * L::kTile,\n"
         "                          vbuf + ((t + 1) & 1) * L::kTile);"),),
        True),
}


def mutant_source(text: str, section: str, edits) -> str:
    """``text`` with each edit applied once inside the ``section`` kernel
    ("bf16" or "fp32")."""
    cut = text.index(FP32_BANNER)
    parts = {"bf16": text[:cut], "fp32": text[cut:]}
    for old, new in edits:
        if parts[section].count(old) != 1:
            raise RuntimeError(f"edit target not found once: {old!r}")
        parts[section] = parts[section].replace(old, new)
    return parts["bf16"] + parts["fp32"]


def build_all(workdir: Path) -> dict[str, Path]:
    text = (_build.CSRC / "flash_attention.cu").read_text()
    nvcc = _build.nvcc_path()
    procs = {}
    for i, (name, (section, edits, _)) in enumerate(FAULTS.items()):
        src = workdir / f"fault{i}.cu"
        src.write_text(mutant_source(text, section, edits))
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
    cases = cs.flash_cases(prefill)
    bad = []
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(Path(tmp))
        for name, lib in libs.items():
            use(lib)
            section, edits, must_fail = FAULTS[name]
            caught, caught_old = [], False
            for label, (b, sq, sk, h, kvh, d), dtype, causal, (bq, bk) in cases:
                tag = "bf16" if dtype == torch.bfloat16 else "fp32"
                if edits and tag != section:
                    continue
                q, k, v = cs.flash_operands(b, sq, sk, h, kvh, d, dtype, dev,
                                            seed=sq + sk)
                try:
                    r = cs.flash_readings(q, k, v, causal, bq, bk)
                except RuntimeError as e:  # a non-finite or misshapen output
                    r, failed = {"error": str(e)}, [str(e)]
                    old = True
                else:
                    failed = cs.flash_failures(r, tag)
                    old = r["norm_err"] > OLD_TOL
                results[f"{name} | {label} {tag}"] = dict(
                    r, failed=failed, old_limit_fails=old)
                caught += failed
                caught_old |= old
                print(f"{name:<46} {label:<10} {tag} {json.dumps(r)} "
                      f"fails: {failed or 'none'}"
                      + (f"; former limit {'fails' if old else 'passes'}"
                         if tag == "bf16" else ""), flush=True)
                del q, k, v
            print(f"-> {name}: {'CAUGHT' if caught else 'passes every check'}"
                  + (f" (former limit: {'caught' if caught_old else 'missed'})"
                     if section == "bf16" else ""), flush=True)
            if name == "unedited" and caught:
                bad.append("the unedited kernel fails a check")
            if must_fail and not caught:
                bad.append(f"fault {name!r} passes every check")
    print(json.dumps({"card": card, "readings": results, "bad": bad}),
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
