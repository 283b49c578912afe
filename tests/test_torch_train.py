"""Port parity of the training path: ``repro_torch.models.model.loss_fn``,
its gradients and ``repro_torch.train.make_train_step`` against
``repro.models.model.loss_fn``, ``jax.grad`` and ``repro.train.
make_train_step`` on the same weights and batches.

The reference's ``init_params`` tree is carried across with
``params_from_jax``; batches are ``SyntheticLM``'s numpy draws, handed to
both packages.  The reference's train step is jitted, as its ``Trainer``
runs it; the port's runs eagerly.  Tolerances are stated beside each
check, as max |port - ref| / max |ref| over a leaf unless said otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import BatchSpec as JBatchSpec
from repro.data import SyntheticLM as JSyntheticLM
from repro.distributed import compression as jcompression
from repro.distributed.shardings import MeshRules
from repro.launch.train import scaled_config as jscaled_config
from repro.models import config as JC
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import params as JP
from repro.models.config import ArchConfig as JArchConfig
from repro.optim import AdamW as JAdamW
from repro.train import make_train_step as jmake_train_step
from repro_torch import tree as tree_util
from repro_torch.distributed import compression
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.train import scaled_config
from repro_torch.models import config as C
from repro_torch.models import layers, model
from repro_torch.models import params as P
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamW
from repro_torch.train import make_train_step
from repro_torch.train.step import _value_and_grad

RULES = MeshRules.single_device()
#: tests/test_substrate.py's TINY config
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, attn_chunked_above=10 ** 9,
            dtype="float32")
SCALE = 0.04
B, S = 4, 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor operations: one thread per test worker, for the
    module's fixtures too (idle pool threads spin and starve the other
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: loss, logits and every gradient leaf, port vs reference.  fp32: the same
#: fp32 arithmetic, matmul sums, exp/log and sin/cos from other libraries,
#: through two layers and back (measured <= 1.4e-6 over the leaves of four
#: configs).  bf16: a value one fp32 ulp apart before a bf16 cast can round
#: to the neighbouring bf16 value (2**-8 relative), and such flips spread
#: through the layers and the backward pass (measured <= 2.2e-2 on the
#: gradient leaves, 6.7e-3 on logits, 1.3e-5 on the fp32 loss)
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
#: the loss and its metrics, relative (measured <= 1.3e-5 in bf16: the
#: fp32 cross-entropy averages the logits' flips away)
LOSS_TOL = {"float32": 1e-6, "bfloat16": 1e-4}
#: the flash route's plain version against _attn_full, fp32: the online
#: softmax in 512-key blocks against one pass (tests/test_torch_lm.py)
FLASH_VS_XLA_TOL = 2e-5
#: the optimizer's learning rate in the step comparisons, and for fp32 the
#: element bound on the parameters after the steps, |port - ref| <= ATOL +
#: RTOL*|ref|: test_substrate.py's bound for accum 1 against accum 2 at
#: this lr
LR = 1e-3
STEP_ATOL, STEP_RTOL = 5e-5, 1e-3
#: Adam's first steps divide m by sqrt(v): an element whose gradient lies
#: within fp32 noise of 0 takes a step of another size, up to lr apart;
#: with int8 compression, so does one whose gradient lies within noise of a
#: midpoint of its int8 grid (it rounds to the other level).  Up to this
#: share of elements may leave the element bound (measured: 1 of 106816
#: for tiny, accum 2 and int8; a few for stablelm-3b's one step), each
#: within 2 * 3 * LR, the most two 3-step Adam paths can part
FLIP_SHARE = 1e-3
#: int8, fp32: the share of error-feedback residuals more than 1e-3 of
#: their leaf's largest apart.  A flip moves a residual by a whole level;
#: an element within 127 x (gradient noise, ~1e-6 of the leaf's largest
#: gradient) of a midpoint flips, about 2.5e-4 of the elements per step,
#: more as the parameters part (measured 1.3e-3 after 3 steps)
RESIDUAL_SHARE = 5e-3
#: per leaf, ||port - ref|| / ||ref|| of the steps' parameter update and of
#: the moments m and v.  fp32: measured <= 4.2e-4 (int8, with a flip).
#: bf16: every gradient moves by up to 2e-2 and the elements of smallest
#: gradient turn that into up to lr per step (measured <= 0.12 on the
#: updates, 0.05 on the moments)
NORM_TOL = {"float32": 1e-3, "bfloat16": 0.2}


def _configs(arch, dtype, **kw):
    if arch == "tiny":
        return (dataclasses.replace(JArchConfig(**TINY), dtype=dtype, **kw),
                dataclasses.replace(ArchConfig(**TINY), dtype=dtype, **kw))
    return (dataclasses.replace(jscaled_config(JC.get(arch), SCALE),
                                dtype=dtype, **kw),
            dataclasses.replace(scaled_config(C.get(arch), SCALE), dtype=dtype,
                                **kw))


def _port(jp):
    return P.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(jcfg, step=0, seed=1, b=B, s=S):
    np_batch = JSyntheticLM(jcfg, JBatchSpec(b, s), seed=seed)(step)
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in np_batch.items()})


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def _rel(got, want):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _grad_rels(tgrads, jgrads):
    """Per-leaf relative error, leaves in the reference's order."""
    tl, jl = list(tree_util.leaves(tgrads)), jax.tree.leaves(jgrads)
    assert len(tl) == len(jl)
    return [_rel(t, j) for t, j in zip(tl, jl)]


CASES = [("tiny", "float32"), ("qwen3-0.6b", "bfloat16")]


@pytest.mark.parametrize("arch,dtype", CASES)
def test_loss_and_metrics_match_the_reference(arch, dtype):
    jcfg, cfg = _configs(arch, dtype)
    jp = JP.init_params(jcfg, jax.random.PRNGKey(1))
    jb, tb = _batch(jcfg)
    # a masked label in each row: the mask and the denominator are used
    jb["labels"] = jb["labels"].at[:, 3].set(-1)
    tb["labels"][:, 3] = -1
    jl, jm = JM.loss_fn(jcfg, RULES, jp, jb)
    tl, tm = model.loss_fn(cfg, _port(jp), tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert float(tm["tokens"]) == float(jm["tokens"]) == B * (S - 1)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    for key in ("ce", "z"):
        assert _rel(tm[key], jm[key]) <= LOSS_TOL[dtype], key
    assert _rel(tl, jl) <= LOSS_TOL[dtype]
    # the z-loss is z_coef * mean(lse ** 2): near 1e-4 * ln(V) ** 2 at init
    assert 0.5e-4 < float(tm["z"]) / np.log(cfg.padded_vocab) ** 2 < 2e-4


@pytest.mark.parametrize("arch,dtype", CASES)
def test_every_gradient_leaf_matches_jax_grad(arch, dtype):
    jcfg, cfg = _configs(arch, dtype)
    jp = JP.init_params(jcfg, jax.random.PRNGKey(1))
    jb, tb = _batch(jcfg)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, RULES, p, jb), has_aux=True)(jp)
    tl, _, tg = _value_and_grad(cfg, _port(jp), tb)
    assert _rel(tl, jl) <= LOSS_TOL[dtype]
    names = ["/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    rels = _grad_rels(tg, jg)
    assert len(rels) == len(list(tree_util.leaves(P.param_defs(cfg))))
    for name, r in zip(names, rels):
        assert r <= TOL[dtype], (name, r)
    for x in tree_util.leaves(tg):
        assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())


def _run_steps(jcfg, cfg, *, accum=1, comp="none", accum_dtype=None, n=3):
    """n steps of each package's train step from the reference's params."""
    jopt, opt = JAdamW(learning_rate=LR), AdamW(learning_rate=LR)
    jkw, kw = {}, {}
    if accum_dtype is not None:
        jkw["accum_dtype"], kw["accum_dtype"] = jnp.bfloat16, torch.bfloat16
    jstep = jax.jit(jmake_train_step(jcfg, RULES, jopt, accum=accum,
                                     grad_compression=comp, **jkw))
    step = make_train_step(cfg, opt, accum=accum, grad_compression=comp, **kw)
    jp = JP.init_params(jcfg, jax.random.PRNGKey(2))
    tp = _port(jp)
    js, ts = jopt.init(jp), opt.init(tp)
    je, te = jcompression.zeros_error(jp), compression.zeros_error(tp)
    hist = []
    for i in range(n):
        jb, tb = _batch(jcfg, step=i)
        if comp == "int8":
            jp, js, jm, je = jstep(jp, js, jb, je)
            tp, ts, tm, te = step(tp, ts, tb, te)
        else:
            jp, js, jm = jstep(jp, js, jb)
            tp, ts, tm = step(tp, ts, tb)
        hist.append((jm, tm))
    return (jp, js, je), (tp, ts, te), hist


def _param_excess(tp, jp):
    """Per element, how far past the element bound the port's parameters
    are."""
    out = []
    for t, j in zip(tree_util.leaves(tp), jax.tree.leaves(jp)):
        t, j = _f64(t), _f64(j)
        out.append((np.abs(t - j) - (STEP_ATOL + STEP_RTOL * np.abs(j))).ravel())
    return np.concatenate(out)


def _norm_rel(t_tree, j_tree, j_base=None):
    """Worst leaf's ||port - ref|| / ||ref - base||."""
    out = []
    bases = (jax.tree.leaves(j_base) if j_base is not None
             else [0.0] * len(jax.tree.leaves(j_tree)))
    for t, j, b in zip(tree_util.leaves(t_tree), jax.tree.leaves(j_tree),
                       bases):
        t, j, b = _f64(t), _f64(j), _f64(b)
        out.append(np.linalg.norm(t - j) / max(np.linalg.norm(j - b), 1e-30))
    return max(out)


STEP_CASES = [
    ("tiny", "float32", 1, "none", None),
    ("tiny", "float32", 2, "none", None),
    ("tiny", "float32", 2, "none", "bfloat16"),
    ("tiny", "float32", 1, "int8", None),
    ("qwen3-0.6b", "bfloat16", 1, "none", None),
    ("qwen3-0.6b", "bfloat16", 2, "int8", None),
]


@pytest.mark.parametrize("arch,dtype,accum,comp,accum_dtype", STEP_CASES)
def test_train_step_matches_the_reference_over_three_steps(
        arch, dtype, accum, comp, accum_dtype):
    jcfg, cfg = _configs(arch, dtype)
    j0 = JP.init_params(jcfg, jax.random.PRNGKey(2))
    (jp, js, je), (tp, ts, te), hist = _run_steps(
        jcfg, cfg, accum=accum, comp=comp, accum_dtype=accum_dtype)
    for jm, tm in hist:
        assert set(tm) == set(jm)
        for key in ("loss", "ce", "z"):
            assert _rel(tm[key], jm[key]) <= LOSS_TOL[dtype], key
        # gnorm sums every leaf's squares: the gradients' tolerance
        assert _rel(tm["gnorm"], jm["gnorm"]) <= TOL[dtype]
        assert float(tm["lr"]) == float(jm["lr"])
        assert float(tm["tokens"]) == float(jm["tokens"])
    assert ts.count.dtype == torch.int32 and int(ts.count) == int(js.count) == 3
    assert _norm_rel(tp, jp, j0) <= NORM_TOL[dtype]
    assert _norm_rel(ts.m, js.m) <= NORM_TOL[dtype]
    assert _norm_rel(ts.v, js.v) <= NORM_TOL[dtype]
    excess = _param_excess(tp, jp)
    assert excess.max() <= 2 * 3 * LR - STEP_ATOL
    if dtype == "float32":
        assert (excess > 0).mean() <= FLIP_SHARE
    if comp == "int8":
        # the error-feedback residuals: a flip moves its element's residual
        # by a whole int8 level, so fp32 holds the share of elements that
        # differ by more than 1e-3 of the leaf's largest residual; in bf16
        # every residual moves with its gradient's noise
        far = []
        for t, j in zip(tree_util.leaves(te), jax.tree.leaves(je)):
            t, j = _f64(t), _f64(j)
            assert t.shape == j.shape and np.isfinite(t).all()
            far.append((np.abs(t - j) > 1e-3 * np.abs(j).max()).ravel())
        if dtype == "float32":
            assert np.concatenate(far).mean() <= RESIDUAL_SHARE


@pytest.mark.parametrize("accum_dtype", (torch.float32, torch.bfloat16))
def test_accumulation_rounds_once_per_add(accum_dtype):
    """accum = 2 sums the two microbatch gradients in ``accum_dtype``, each
    cast once before its add, then divides by 2 in fp32: the port's step
    equals that sum of its own per-microbatch gradients bit for bit."""
    _, cfg = _configs("tiny", "float32")
    pp = P.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    _, tb = _batch(JArchConfig(**TINY))
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in tb.items()} for i in (0, 1)]
    gs = [_value_and_grad(cfg, pp, h)[2] for h in halves]
    want = tree_util.map(
        lambda a, b: ((torch.zeros_like(a, dtype=accum_dtype)
                       + a.to(accum_dtype)) + b.to(accum_dtype)).float() / 2,
        gs[0], gs[1])
    seen = {}

    class Spy(AdamW):
        def update(self, grads, state, params):
            seen["grads"] = grads
            return super().update(grads, state, params)

    opt = Spy(learning_rate=LR)
    step = make_train_step(cfg, opt, accum=2, accum_dtype=accum_dtype)
    step(pp, opt.init(pp), tb)
    for got, exp in zip(tree_util.leaves(seen["grads"]), tree_util.leaves(want)):
        assert torch.equal(got, exp)


def test_remat_modes_give_the_same_loss_and_gradients():
    """none / full / dots recompute the same ops on the same inputs, so the
    loss and every gradient are bit for bit the same.  ``dots`` keeps the
    unbatched matmuls' outputs, so its backward recomputes no ``mm``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                self.mm += 1
            return func(*args, **(kwargs or {}))

    _, base = _configs("qwen3-0.6b", "float32")
    pp = P.init_params(base, torch.Generator().manual_seed(0), device="cpu")
    _, tb = _batch(JArchConfig(**TINY), b=2, s=16)
    tb = {k: v % base.vocab_size for k, v in tb.items()}
    out, mms = {}, {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        live = tree_util.map(lambda p: p.detach().requires_grad_(True), pp)
        loss, _ = model.loss_fn(cfg, live, tb)
        with CountMM() as counter:
            grads = torch.autograd.grad(loss, list(tree_util.leaves(live)))
        out[remat], mms[remat] = (loss.detach(), grads), counter.mm
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)
    # per block, full recomputes the forward up to the last tensor the
    # backward needs: 6 of the 7 projections (not wd's output)
    assert mms["full"] == mms["none"] + 6 * base.n_layers
    assert mms["dots"] == mms["none"]


@pytest.mark.parametrize("arch", ("deepseek-67b", "stablelm-3b",
                                  "stablelm-12b"))
def test_other_dense_configs_match_the_reference(arch):
    """Untied heads, no qk-norm: forward logits and one train step."""
    jcfg, cfg = _configs(arch, "float32")
    assert dataclasses.asdict(C.get(arch)) == dataclasses.asdict(JC.get(arch))
    assert not cfg.tie_embeddings and not cfg.qk_norm
    assert P.count_params(C.get(arch)) == JP.count_params(JC.get(arch))
    jp = JP.init_params(jcfg, jax.random.PRNGKey(0))
    jb, tb = _batch(jcfg, b=2)
    assert "lm_head" in jp and "qn" not in jp["blocks"]
    jlog, _ = JM.forward(jcfg, RULES, jp, jb, train=False)
    tlog, _ = model.forward(cfg, _port(jp), tb)
    assert _rel(tlog, jlog) <= TOL["float32"]
    (jp1, _, _), (tp1, _, _), hist = _run_steps(jcfg, cfg, n=1)
    jm, tm = hist[0]
    assert _rel(tm["loss"], jm["loss"]) <= LOSS_TOL["float32"]
    assert _rel(tm["gnorm"], jm["gnorm"]) <= TOL["float32"]
    assert _norm_rel(tp1, jp1, JP.init_params(jcfg, jax.random.PRNGKey(2))) \
        <= NORM_TOL["float32"]
    excess = _param_excess(tp1, jp1)
    assert (excess > 0).mean() <= FLIP_SHARE
    assert excess.max() <= 2 * LR - STEP_ATOL


def test_flash_plain_route_gradient_matches_attn_full():
    """On the CPU the flash route's plain version is differentiable: its
    gradients are _attn_full's (the port's and the reference's)."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32)))
    cot = rng.standard_normal((2, 64, 4, 32)).astype(np.float32)
    grads = {}
    for route in ("flash", "xla"):
        ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        if route == "flash":
            out = fa.flash_attention(*ts, causal=True, block_q=32, block_k=16)
        else:
            out = layers._attn_full(*ts, causal=True)
        grads[route] = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    _, jvjp = jax.vjp(lambda a, b, c: jlayers._attn_full(a, b, c, causal=True),
                      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = jvjp(jnp.asarray(cot))
    for got, want, jw in zip(grads["flash"], grads["xla"], jgrads):
        assert _rel(got, want) <= FLASH_VS_XLA_TOL
        assert _rel(want, jw) <= TOL["float32"]


def test_flash_config_trains_on_the_cpu():
    """attn_impl="flash" trains through the plain route on the CPU, as the
    reference trains it through _attn_full off the TPU, and the launch
    count stays 0."""
    jcfg, cfg = _configs("qwen3-0.6b", "float32", attn_impl="flash")
    jp = JP.init_params(jcfg, jax.random.PRNGKey(1))
    jb, tb = _batch(jcfg)
    launches = fa.flash_attention.launches
    (jl, _), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, RULES, p, jb), has_aux=True)(jp)
    tl, _, tg = _value_and_grad(cfg, _port(jp), tb)
    assert _rel(tl, jl) <= LOSS_TOL["float32"]
    assert max(_grad_rels(tg, jg)) <= FLASH_VS_XLA_TOL
    assert fa.flash_attention.launches == launches


def test_train_step_refuses_unknown_compression():
    _, cfg = _configs("tiny", "float32")
    with pytest.raises(ValueError, match="grad_compression"):
        make_train_step(cfg, AdamW(), grad_compression="fp8")
