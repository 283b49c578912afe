"""Per-device cost of a step, counted from the aten ops it dispatches.

The reference's module of this name parses XLA's optimized HLO text and
derives FLOPs, HBM bytes and collective wire bytes from it, loop trip
counts included.  The port has no HLO: it runs the step eagerly on
``meta`` tensors (no allocation, no arithmetic) under :class:`OpCounter`,
a ``TorchDispatchMode`` that sees every aten op the step dispatches,
forward and backward, each loop iteration as it runs.  So this module
counts dispatched aten ops, not HLO; the name is kept so the module
stands beside its reference counterpart.

  * FLOPs: products (``mm``, ``bmm``, ``addmm``, attention, convolution)
    take ``torch.utils.flop_counter``'s registered formulas and count in
    ``dot_flops`` too; elementwise ops take the reference's per-element
    weights (``_EW1`` 1, ``_EW4`` 4, ``_EW8`` 8 per result element), a
    reduction 4 per result element, as the reference's ``reduce``;
  * HBM bytes: each op's operand plus result bytes, views excluded.
    Eager PyTorch materialises every op's result, so this is the port's
    true traffic, not an upper bound (XLA's fusions would keep some of it
    in registers);
  * kernels: a launch of K1, K2 or K3 on ``meta`` counts as one op with
    the kernel's own work (``kernels.bounds``), as the reference's
    ``VMEM_MARKER`` region bills a Pallas kernel: K3's products count in
    ``dot_flops``, K1's and K2's pair terms in ``flops`` only.  With
    ``expand_kernels`` each launch runs its plain PyTorch version on
    ``meta`` instead, op by op (the reference's XLA stand-in);
  * peak memory: the live bytes of the storages the step creates.  A new
    storage adds its bytes once (views and in-place results share their
    base's storage); its bytes come off when the last tensor on it dies,
    including the tensors autograd saved for the backward pass, which stay
    live as they do on the card.  Tensors made before the counter starts
    (parameters, inputs) are the caller's to add;
  * collectives: the caller lists them (``add_collective``) and the
    reference's ring model (``collective_wire``) turns each into wire
    bytes.

All numbers are per device when the step runs at one device's local
shapes (``launch.dryrun``).
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import bounds

# per-element flop weights of elementwise ops (the reference's XLA-cost-
# analysis-like table, by aten name; in-place variants share their op's)
_EW1 = ("add", "sub", "rsub", "mul", "maximum", "minimum", "neg", "abs",
        "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
        "logical_and", "logical_or", "logical_xor", "logical_not", "eq",
        "ne", "lt", "le", "gt", "ge", "where", "clamp", "clamp_min",
        "clamp_max", "sign", "floor", "ceil", "round", "trunc", "masked_fill",
        "square", "relu", "threshold_backward", "lerp", "addcmul")
_EW4 = ("div", "remainder", "fmod", "sqrt", "rsqrt", "reciprocal",
        "addcdiv")
_EW8 = ("exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
        "sigmoid", "pow", "atan2", "sin", "cos", "tan", "erf", "erfc",
        "silu", "softplus", "gelu", "sigmoid_backward", "tanh_backward",
        "silu_backward", "softplus_backward", "gelu_backward")
#: reductions: 4 per result element, the reference's combiner estimate
_REDUCE = ("sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
           "argmin", "logsumexp", "var", "std", "var_mean", "norm",
           "linalg_vector_norm", "cumsum", "any", "all")
#: softmax as its parts (max, subtract, exp, sum, divide) per element
_SOFTMAX = {"_softmax": 15, "_log_softmax": 15,
            "_softmax_backward_data": 3, "_log_softmax_backward_data": 10}
_WEIGHT = {**{n: 1 for n in _EW1}, **{n: 4 for n in _EW4},
           **{n: 8 for n in _EW8}, **_SOFTMAX}
#: ops that move no bytes: allocations and metadata
_NO_BYTES = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh")

COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute")


def collective_wire(op: str, result_bytes: float, group: int) -> float:
    """Wire bytes per device of one collective (the reference's ring
    model, ``hlo_analysis._collective_wire``): ``result_bytes`` is the
    per-device result, ``group`` the devices taking part."""
    if op not in COLL_OPS:
        raise ValueError(f"unknown collective {op!r}; one of {COLL_OPS}")
    rb = float(result_bytes)
    if op == "collective-permute":
        return rb          # every device sends + receives its payload
    if group <= 1:
        return 0.0
    if op == "all-gather":
        return rb * (group - 1) / group
    if op == "all-reduce":
        return 2.0 * rb * (group - 1) / group
    if op == "reduce-scatter":
        return rb * (group - 1)
    return rb * (group - 1) / group      # all-to-all


def _tensors(tree, out=None) -> list:
    """The tensors in nested lists, tuples and dicts."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _NotMeta(Exception):
    pass


def _layout(x):
    """A hashable picture of an argument: each meta tensor by its layout
    (raises ``_NotMeta`` on another device's tensor)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _NotMeta
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_layout(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _layout(v)) for k, v in sorted(x.items()))
    return x


def _layout_key(head, args, kwargs):
    try:
        key = (head, _layout(args), _layout(kwargs))
        hash(key)
    except (_NotMeta, TypeError):
        return None
    return key


_PURE: dict = {}


def _memo_key(func, args, kwargs):
    """A key under which an op's outputs and cost depend on nothing but
    the input layouts, or None: ops that alias or write their inputs, and
    ops on anything but meta tensors, run every time."""
    pure = _PURE.get(func)
    if pure is None:
        schema = func._schema
        pure = _PURE[func] = not (
            func.is_view
            or any(r.alias_info is not None for r in schema.returns)
            or any(a.alias_info is not None and a.alias_info.is_write
                   for a in schema.arguments))
    return _layout_key(func, args, kwargs) if pure else None


def _fresh(out, outs, in_keys) -> bool:
    """Whether ``out`` is one new tensor or a tuple of new tensors on
    storages of their own (so that empty ones of the same layout stand
    for it)."""
    items = out if isinstance(out, tuple) else (out,)
    if len(items) != len(outs) or not outs:
        return False
    keys = [t.untyped_storage()._cdata for t in outs]
    return (len(set(keys)) == len(keys) and not set(keys) & in_keys
            and all(t.storage_offset() == 0 for t in outs))


class _Saved:
    """A tensor autograd saved for the backward pass, boxed so that the
    counter learns when autograd lets it go."""
    __slots__ = ("t", "__weakref__")

    def __init__(self, t):
        self.t = t


def _storage_use_count(storage) -> int:
    return torch._C._storage_Use_Count(storage._cdata)


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes, live memory and kernel launches of the aten
    ops dispatched while it is active (see the module docstring).  Enter it
    with ``with``; read ``summary()`` after."""

    def __init__(self, *, expand_kernels: bool = False):
        super().__init__()
        self.expand_kernels = expand_kernels
        self.flops = 0.0
        self.dot_flops = 0.0
        self.hbm_bytes = 0.0
        self.ops = 0
        self.kernels: dict = {}
        self.coll = {op: 0.0 for op in COLL_OPS}
        self.coll_counts = {op: 0 for op in COLL_OPS}
        self.live = 0
        self.peak = 0
        self._storages: dict = {}   # storage key -> [storage, nbytes, refs]
        self._suspects: set = set()
        self._memo: dict = {}       # op and input layouts -> outputs, cost
        self._calls: dict = {}      # the same for ``memoize``d functions

    # -- context ----------------------------------------------------------
    def __enter__(self):
        bounds.COUNTERS.append(self)
        self._saved = torch.autograd.graph.saved_tensors_hooks(
            self._pack, self._unpack)
        self._saved.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        bounds.COUNTERS.remove(self)
        self._saved.__exit__(*exc)
        return super().__exit__(*exc)

    # -- live memory -------------------------------------------------------
    def _drop_ref(self, key):
        entry = self._storages.get(key)
        if entry is not None:
            entry[2] -= 1
            if entry[2] == 0:
                self._suspects.add(key)

    def _pack(self, t):
        """A saved tensor holds its storage until autograd frees it."""
        entry = self._storages.get(t.untyped_storage()._cdata) \
            if t.device.type == "meta" else None
        if entry is None:
            return t
        box = _Saved(t)
        self._hold(entry, box)
        return box

    @staticmethod
    def _unpack(x):
        return x.t if isinstance(x, _Saved) else x

    def _hold(self, entry, holder):
        key = entry[0]._cdata
        entry[2] += 1
        self._suspects.discard(key)
        weakref.finalize(holder, self._drop_ref, key)

    def _reap(self):
        """Free the storages that nothing holds any more: no Python tensor
        or saved tensor refers to them and only this counter's reference is
        left (a storage some other holder keeps stays a suspect)."""
        for key in [k for k in self._suspects
                    if _storage_use_count(self._storages[k][0]) == 1]:
            self._suspects.discard(key)
            self.live -= self._storages.pop(key)[1]

    def _allocate(self, nbytes):
        """A new storage's bytes; the suspects are reaped only when the
        peak would rise, which gives the same peak: until then the live
        count, dead suspects included, stays below it."""
        if self.live + nbytes > self.peak:
            self._reap()
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def _track(self, outs, in_keys):
        for t in outs:
            if t.device.type != "meta":
                continue
            st = t.untyped_storage()
            key = st._cdata
            entry = self._storages.get(key)
            if entry is None:
                if key in in_keys:
                    continue          # a view of a tensor made outside
                entry = self._storages[key] = [st, st.nbytes(), 0]
                self._allocate(entry[1])
            self._hold(entry, t)

    # -- counting ----------------------------------------------------------
    def kernel(self, name, *, flops, dot_flops, nbytes):
        """One launch of a hand-written kernel on ``meta``, counted as one
        op with its own work (``kernels.bounds.meta_launch``)."""
        self.ops += 1
        self.flops += flops
        self.dot_flops += dot_flops
        self.hbm_bytes += nbytes
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def memoize(self, fn):
        """``fn`` (a function of meta tensors whose outputs alias none of
        its inputs) counted once per input layout: a later call on the
        same layouts adds the recorded cost, kernel launches and peak, and
        returns fresh outputs of the recorded layouts (sharing storage as
        the recorded ones did), without running ``fn`` again.  The mesh
        simulations call one kernel wrapper P^2 times on one layout."""

        def wrapper(*args, **kwargs):
            key = _layout_key(fn, args, kwargs)
            if key is None:
                return fn(*args, **kwargs)
            hit = self._calls.get(key)
            if hit is None:
                hit = self._calls[key] = self._record_call(fn, args, kwargs)
                return hit.pop("out")
            return self._replay(hit)

        return wrapper

    def _record_call(self, fn, args, kwargs):
        self._reap()
        before = (self.flops, self.dot_flops, self.hbm_bytes, self.ops,
                  dict(self.kernels), self.live, self.peak)
        self.peak = self.live
        out = fn(*args, **kwargs)
        call_peak = self.peak - before[5]
        self.peak = max(self.peak, before[6])
        outs = _tensors(out)
        bases, views = {}, []
        for t in outs:
            st = t.untyped_storage()
            idx = bases.setdefault(st._cdata, (len(bases), st.nbytes()))[0]
            views.append((idx, tuple(t.shape), t.stride(),
                          t.storage_offset(), t.dtype))
        return {"out": out, "tuple": isinstance(out, tuple),
                "cost": (self.flops - before[0], self.dot_flops - before[1],
                         self.hbm_bytes - before[2], self.ops - before[3]),
                "kernels": {k: v - before[4].get(k, 0)
                            for k, v in self.kernels.items()},
                "peak": call_peak,
                "bases": [nb for _, nb in sorted(bases.values())],
                "views": views}

    def _replay(self, hit):
        flops, dots, nbytes, ops = hit["cost"]
        self.flops += flops
        self.dot_flops += dots
        self.hbm_bytes += nbytes
        self.ops += ops
        for k, v in hit["kernels"].items():
            self.kernels[k] = self.kernels.get(k, 0) + v
        if self.live + hit["peak"] > self.peak:
            self._reap()
            self.peak = max(self.peak, self.live + hit["peak"])
        with _disable_current_modes():
            bases = [torch.empty(nb, dtype=torch.uint8, device="meta")
                     for nb in hit["bases"]]
            outs = [bases[i].view(dt).as_strided(shape, stride, off)
                    for i, shape, stride, off, dt in hit["views"]]
        for b in bases:
            st = b.untyped_storage()
            self._storages[st._cdata] = [st, st.nbytes(), 0]
            self._allocate(st.nbytes())
        self._track(outs, ())
        return tuple(outs) if hit["tuple"] else outs[0]

    def add_collective(self, op, result_bytes, group, count=1):
        """``count`` collectives of class ``op``, each with a per-device
        result of ``result_bytes`` over ``group`` devices."""
        wire = collective_wire(op, result_bytes, group)
        if wire:
            self.coll[op] += count * wire
            self.coll_counts[op] += count

    def _cost(self, func, args, kwargs, out, ins, outs):
        """(flops, dot_flops, bytes) of one op."""
        packet = func._overloadpacket
        name = packet.__name__.rstrip("_")
        flops = dots = 0.0
        if packet in flop_registry:
            flops = dots = flop_registry[packet](*args, **kwargs, out_val=out)
        elif name in _WEIGHT:
            flops = _WEIGHT[name] * sum(t.numel() for t in outs)
        elif name in _REDUCE:
            flops = 4 * sum(t.numel() for t in outs)
        nbytes = 0 if func.is_view or name in _NO_BYTES else sum(
            _nbytes(t) for t in ins + outs)
        return flops, dots, nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        key = _memo_key(func, args, kwargs)
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            # same op on the same shapes: fresh outputs of the recorded
            # layout and the recorded cost, without running the meta
            # kernel again
            specs, cost = hit
            outs = [torch.empty_strided(shape, stride, dtype=dt, device="meta")
                    for shape, stride, dt in specs]
            out = outs[0] if len(outs) == 1 and not isinstance(
                hit[0], list) else tuple(outs)
            in_keys = ()
        else:
            out = func(*args, **kwargs)
            ins, outs = _tensors((args, kwargs)), _tensors(out)
            cost = self._cost(func, args, kwargs, out, ins, outs)
            in_keys = {t.untyped_storage()._cdata for t in ins
                       if t.device.type == "meta"}
            if key is not None and _fresh(out, outs, in_keys):
                specs = [(tuple(t.shape), t.stride(), t.dtype) for t in outs]
                self._memo[key] = (specs if isinstance(out, tuple)
                                   else tuple(specs), cost)
        self.flops += cost[0]
        self.dot_flops += cost[1]
        self.hbm_bytes += cost[2]
        self._track(outs, in_keys)
        return out

    def summary(self) -> dict:
        """The reference's keys (``flops``, ``dot_flops``, ``hbm_bytes``,
        ``collectives`` with ``counts`` and ``total``) and the counter's
        own: ``peak_bytes`` (live storages created inside), ``ops`` and
        ``kernels`` (launches per kernel)."""
        return {
            "flops": self.flops,
            "dot_flops": self.dot_flops,
            "hbm_bytes": self.hbm_bytes,
            "collectives": dict(self.coll, counts=dict(self.coll_counts),
                                total=sum(self.coll.values())),
            "peak_bytes": self.peak,
            "ops": self.ops,
            "kernels": dict(self.kernels),
        }


def analyze(fn, *args, expand_kernels: bool = False, **kwargs) -> dict:
    """Per-device cost of ``fn(*args, **kwargs)`` run on ``meta`` tensors
    under an :class:`OpCounter`; returns its ``summary()``."""
    with OpCounter(expand_kernels=expand_kernels) as counter:
        fn(*args, **kwargs)
    return counter.summary()


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in a tree (parameters, optimizer state,
    inputs): what the caller adds to the counter's live peak."""
    return sum(_nbytes(t) for t in _tensors(tree))

