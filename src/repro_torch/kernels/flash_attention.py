"""Grouped-query flash attention (causal or not).

Port of ``repro/kernels/flash_attention.py``.  Public layout as in the
reference: q (B, Sq, H, D), k and v (B, Sk, KV, D) with H a multiple of KV;
the output is (B, Sq, H, D) in q's dtype.  The G = H / KV query heads of a
kv head are folded into one slab, so each K/V tile serves all G heads.

The tensor's device picks the path.  A CUDA tensor launches the
hand-written kernel of ``csrc/flash_attention.cu`` on the current stream,
or raises; a CPU tensor runs the plain PyTorch version beside it
(``_flash_plain``), which computes the Pallas function block by block in
the reference's (block_q, block_k) order.  ``flash_attention.launches``
counts the kernel's launches.  A ``meta`` tensor (the dry-run,
``launch.dryrun``) launches nothing: the wrapper reports the kernel's
work to the op counter (``kernels.bounds.meta_launch``) and returns an
empty result of the kernel's shape, or the plain version run on ``meta``
when the counter asks for it.

On a device mesh q, k and v are ``DTensor``s: q sharded on B and H, k
and v on B and KV (or whole on KV where the kv heads do not split as the
q heads do).  The wrapper runs on each rank's local block through
``local_map``, the kernel (or its plain version) at the local shape, and
returns a DTensor with q's placements; the local q heads read their own
kv heads (``local_kv``), so the group size is the global one.

The reference computes ``grid = Sq // block_q`` and so leaves rows
unwritten, silently, when block_q does not divide Sq.  This wrapper raises
on ``Sq % block_q`` or ``Sk % block_k`` instead.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.shardings import block_index
from repro_torch.kernels import _build, bounds

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
NEG_INF = -1e30

_DTYPES = (torch.bfloat16, torch.float32)


def _flash_plain(q, k, v, *, causal: bool, block_q: int, block_k: int):
    """The Pallas kernel's arithmetic in PyTorch: per (block_q, block_k)
    tile, fp32 scores of the exact products, an online softmax in fp32, p
    rounded to v's dtype for the PV product while l sums the unrounded p,
    and tiles strictly above the diagonal skipped."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d ** -0.5
    f32 = torch.float32
    qs = q.reshape(b, sq, kvh, g, d).transpose(1, 2).to(f32)  # (b, kv, sq, g, d)
    ks = k.transpose(1, 2).to(f32)                            # (b, kv, sk, d)
    vs = v.transpose(1, 2)
    out = torch.empty((b, kvh, sq, g, d), dtype=q.dtype, device=q.device)
    for qi in range(sq // block_q):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        qb = qs[:, :, rows]
        m = torch.full(qb.shape[:-1], NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qb.shape, dtype=f32, device=q.device)
        for ki in range(sk // block_k):
            if causal and ki * block_k > qi * block_q + block_q - 1:
                continue  # strictly above the diagonal
            cols = slice(ki * block_k, (ki + 1) * block_k)
            s = torch.einsum("bnqgd,bnkd->bnqgk", qb, ks[:, :, cols]) * scale
            if causal:
                qpos = torch.arange(rows.start, rows.stop, device=q.device)
                kpos = torch.arange(cols.start, cols.stop, device=q.device)
                live = (qpos[:, None] >= kpos[None, :])[:, None, :]
                s = torch.where(live, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            m = m_new
            pv = torch.einsum("bnqgk,bnkd->bnqgd", p.to(v.dtype).to(f32),
                              vs[:, :, cols].to(f32))
            acc = acc * alpha[..., None] + pv
        out[:, :, rows] = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.transpose(1, 2).reshape(b, sq, h, d)


@functools.cache
def _library():
    lib = _build.load("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                        i32, i32, i32, i32, i32,
                                        ctypes.c_float, ptr]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _check(q, k, v, block_q, block_k):
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, Sk, KV, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         f": same B and D, and KV dividing H")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {_DTYPES}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for x in (k, v):
        if x.device != q.device:
            raise ValueError(f"operands on {q.device} and {x.device}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("q, k and v must be contiguous")
    if block_q <= 0 or block_k <= 0 or sq % block_q or k.shape[1] % block_k:
        raise ValueError(f"Sq={sq} and Sk={k.shape[1]} must be multiples of "
                         f"block_q={block_q} and block_k={block_k}")


def local_kv(k, v, *, h_local: int, h: int, kv: int, block: int):
    """The kv heads that block ``block`` of q's ``h`` heads reads when q
    holds ``h_local`` of them and k, v hold every one of the ``kv`` kv
    heads (the rules keep kv whole where it does not split as q does): the
    local q heads' own kv heads, contiguous, so each keeps its global
    group ``h / kv``.  Where q holds every head, or k and v already hold
    the local q heads' kv heads, they are returned as they are."""
    kv_local = k.shape[2]
    if h_local == h or kv_local * h == kv * h_local:
        return k, v
    g = h // kv
    if kv_local != kv or (h_local % g and g % h_local):
        raise ValueError(f"{h_local} of {h} q heads against {kv_local} of "
                         f"{kv} kv heads: the local q heads do not map onto "
                         f"whole kv heads")
    first, n = block * h_local // g, max(1, h_local // g)
    return (k[:, :, first:first + n].contiguous(),
            v[:, :, first:first + n].contiguous())


def _check_mesh_placements(q, k, v):
    """q split only on B (dim 0) and H (dim 2); k and v split on B as q
    is, and on KV where q is on H or not at all."""
    if not all(isinstance(x, DTensor) for x in (k, v)):
        raise TypeError("q is a DTensor: k and v must be DTensors too")
    for axis, (pq, pk, pv) in enumerate(zip(q.placements, k.placements,
                                            v.placements)):
        ok_q = pq == Replicate() or pq in (Shard(0), Shard(2))
        ok_kv = pk == pv and (pk == pq or (pq == Shard(2)
                                           and pk == Replicate()))
        if not (ok_q and ok_kv):
            raise ValueError(
                f"mesh axis {axis}: q {pq}, k {pk}, v {pv}; flash attention "
                f"takes q split on B or H and k, v split as q (or whole on "
                f"KV where q splits H)")


def _flash_mesh(q, k, v, **kw):
    """The wrapper on each rank's local blocks (``local_map``); a DTensor
    with q's placements."""
    from torch.distributed.tensor.experimental import local_map

    _check_mesh_placements(q, k, v)
    h, kv = q.shape[2], k.shape[2]
    block = block_index(q, 2)

    def local(ql, kl, vl):
        kl, vl = local_kv(kl, vl, h_local=ql.shape[2], h=h, kv=kv,
                          block=block)
        return flash_attention(ql, kl, vl, **kw)

    return local_map(local, out_placements=list(q.placements),
                     in_placements=(q.placements, k.placements,
                                    v.placements),
                     device_mesh=q.device_mesh)(q, k, v)


def flash_attention(q, k, v, *, causal: bool = True,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K):
    """Grouped-query flash attention; see the module docstring.

    On the card the kernel takes bf16 or float32 and head dimensions 16,
    32, 64, 96, 112 and 128; a launch it refuses raises.  It has no backward,
    as the reference kernel has no VJP: on the card, a call that autograd
    would record (grad mode on and q, k or v requiring a gradient) raises
    ``NotImplementedError``.  The CPU's plain version is differentiable,
    as the reference trains ``attn_impl="flash"`` through ``_attn_full``
    off the TPU.
    """
    if isinstance(q, DTensor):
        return _flash_mesh(q, k, v, causal=causal, block_q=block_q,
                           block_k=block_k)
    _check(q, k, v, block_q, block_k)
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, causal=causal, block_q=block_q,
                            block_k=block_k)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward: the reference kernel has no "
            "VJP, so the kernel's output would carry no gradient; train "
            "with attn_impl='xla' (layers._attn_full)")
    if q.device.type == "meta":
        return _meta_launch(q, k, v, causal=causal, block_q=block_q,
                            block_k=block_k)
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the kernel loads 16-byte vectors: q, k and v must "
                         "start on a 16-byte boundary")
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            k.shape[1], h, k.shape[2], d, int(q.dtype == torch.bfloat16),
            int(causal), d ** -0.5, stream)
    if rc:
        raise RuntimeError(f"flash_attention_fwd: CUDA kernel launch failed "
                           f"with cudaError {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _meta_launch(q, k, v, *, causal, block_q, block_k):
    """The launch's work reported to the op counter (the kernel table's
    formulas, ``kernels.bounds``): both products in ``dot_flops``."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dots = bounds.attn_flops(b, sq, sk, h, d, causal)
    out = bounds.meta_launch(
        "flash_attention", dot_flops=dots,
        flops=dots + bounds.ATTN_SOFTMAX_FLOPS * b * h
        * bounds.attn_pairs(sq, sk, causal),
        nbytes=bounds.attn_bytes(b, sq, sk, h, kvh, d, q.element_size()),
        plain=lambda: _flash_plain(q, k, v, causal=causal, block_q=block_q,
                                   block_k=block_k))
    return torch.empty_like(q) if out is None else out
