#!/usr/bin/env python3
"""Why bf16 flash attention (K3) differs from its plain version more often
on long rows: summation order, or an accumulation that drifts.

    python3 flash_long_rows.py

Needs a card and ``nvcc``.  For causal rows of 2048, 8192 and 32768 keys
at the served model's heads (B = 1, H = 16, KV = 8, D = 128, bf16) it
computes, on the same inputs:

- ``kernel``: K3;
- ``plain``: the plain version at the kernel's 64-key tile
  (``_flash_plain``), fp32 sums, each tile's P V summed whole and then
  added to the running output;
- ``chunked``: the same p and maxima, P V added to the running output 16
  keys at a time, the order in which the kernel's tensor-core products
  accumulate (a second fp32 summation order);
- ``exact``: the same fp32 p and maxima, l and P V summed in float64, the
  output rounded once to bf16;
- ``kernel_p``: ``plain`` with the kernel's form of p instead of
  ``exp(s scale - m)``: raw scores s = q.k in fp32, m their running max,
  p = 2^(fma(s, scale log2(e), -(m scale log2(e)))), the FMA rounded once,
  and alpha = 2^((m_old - m) scale log2(e)), both 2^x in fp32.

and prints, per length, the share of outputs where each pair differs, and
for each version against ``exact`` the share of its differing outputs
that lie closer to zero than ``exact``'s.  A sum that differs from
``exact`` by summation order alone leans neither way (about half); a sum
whose additions drop low bits toward zero leans toward zero, more so the
longer the row.  ``kernel`` against ``kernel_p`` shows what is left once
p is formed as the kernel forms it.  Inputs of two kinds: random normal q, k, v (``random``)
and q = 0 (``uniform``: every p is exactly 1 in every version, so only the
sums differ).  The last line is one JSON object with every reading.
"""

from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import flash_attention as fa  # noqa: E402

LENGTHS = (2048, 8192, 32768)
HEADS, KV_HEADS, HEAD_DIM = 16, 8, 128
#: the kernel's key tile (kBf16Keys) and its tensor core's k per product
KERNEL_KEY_TILE = 64
MMA_K = 16
LOG2E = 1.4426950408889634
#: query rows per step of the plain loops (the result does not depend on it)
BLOCK_Q = 2048


def plain(q, k, v, *, chunk=None, acc=torch.float32, exp2=False):
    """``_flash_plain`` at the kernel's key tile, causal, with its P V
    added ``chunk`` keys at a time (None: the whole tile), l and the
    output summed in ``acc``, and with ``exp2`` p formed as the kernel
    forms it (see the module docstring)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    f32 = torch.float32
    scale = d ** -0.5
    scale2 = torch.tensor(scale * LOG2E, dtype=f32, device=q.device)
    qs = q.reshape(b, sq, kvh, g, d).transpose(1, 2).to(f32)
    ks = k.transpose(1, 2).to(f32)
    vs = v.transpose(1, 2).to(f32).to(acc)
    out = torch.empty((b, kvh, sq, g, d), dtype=q.dtype, device=q.device)
    chunk = chunk or KERNEL_KEY_TILE
    bq = min(BLOCK_Q, sq)
    for qi in range(sq // bq):
        rows = slice(qi * bq, (qi + 1) * bq)
        qb = qs[:, :, rows]
        m = torch.full(qb.shape[:-1], fa.NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros(m.shape, dtype=acc, device=q.device)
        o = torch.zeros(qb.shape, dtype=acc, device=q.device)
        qpos = torch.arange(rows.start, rows.stop, device=q.device)
        for ki in range(min(sk, rows.stop) // KERNEL_KEY_TILE):
            cols = slice(ki * KERNEL_KEY_TILE, (ki + 1) * KERNEL_KEY_TILE)
            s = torch.einsum("bnqgd,bnkd->bnqgk", qb, ks[:, :, cols])
            if not exp2:
                s = s * scale
            kpos = torch.arange(cols.start, cols.stop, device=q.device)
            s = torch.where((qpos[:, None] >= kpos[None, :])[:, None, :], s,
                            fa.NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            if exp2:
                alpha = torch.exp2((m - m_new) * scale2)
                nms = -(m_new * scale2)
                # fma(s, scale2, nms): the product is exact in float64
                e = (s.double() * scale2.double() + nms.double()[..., None])
                p = torch.exp2(e.to(f32))
            else:
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
            l = l * alpha.to(acc) + p.to(acc).sum(dim=-1)
            m = m_new
            pr = p.to(v.dtype).to(acc)
            o = o * alpha.to(acc)[..., None]
            for c in range(0, KERNEL_KEY_TILE, chunk):
                o = o + torch.einsum("bnqgk,bnkd->bnqgd", pr[..., c:c + chunk],
                                     vs[:, :, cols.start + c:cols.start + c + chunk])
        out[:, :, rows] = (o / l[..., None]).to(q.dtype)
    return out.transpose(1, 2).reshape(b, sq, h, d)


def readings(versions):
    """Pairwise differing shares, and each version's lean toward zero
    against ``exact``."""
    r = {}
    names = list(versions)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            r[f"{a}!={b}"] = float((versions[a] != versions[b]).float().mean())
    x = versions["exact"].float()
    for a in names:
        if a in ("exact", "kernel_p"):
            continue
        y = versions[a].float()
        diff = y != x
        n = int(diff.sum())
        r[f"{a} toward zero"] = (float((diff & (y.abs() < x.abs())).sum()) / n
                                 if n else None)
    return r


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_long_rows: no card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for sk in LENGTHS:
        g = torch.Generator(device=dev).manual_seed(sk)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for shape in ((1, sk, HEADS, HEAD_DIM),
                                 (1, sk, KV_HEADS, HEAD_DIM),
                                 (1, sk, KV_HEADS, HEAD_DIM)))
        for kind, qq in (("random", q), ("uniform", torch.zeros_like(q))):
            versions = {
                "kernel": fa.flash_attention(qq, k, v, causal=True),
                "plain": plain(qq, k, v),
                "chunked": plain(qq, k, v, chunk=MMA_K),
                "exact": plain(qq, k, v, acc=torch.float64),
                "kernel_p": plain(qq, k, v, exp2=True)}
            torch.cuda.synchronize()
            r = out[f"{kind} {sk}"] = readings(versions)
            if sk == LENGTHS[0]:
                r["plain is _flash_plain"] = bool(torch.equal(
                    versions["plain"], fa._flash_plain(
                        qq, k, v, causal=True, block_q=512, block_k=KERNEL_KEY_TILE)))
            print(f"bf16 causal B=1 Sk={sk} H={HEADS} KV={KV_HEADS} "
                  f"D={HEAD_DIM} {kind}: " + ", ".join(
                      f"{key} {100 * val:.4f}%"
                      if isinstance(val, float) else f"{key} {val}"
                      for key, val in r.items()), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
