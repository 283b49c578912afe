"""The port's dry-run (``repro_torch.launch.dryrun`` and the modules under
it) against the reference's, on the CPU.

* ``MeshRules.spec``, ``abstract_params``, ``param_specs``,
  ``cache_spec``, ``abstract_state`` and ``launch.shapes`` give the
  reference's leaves for all ten configs on both production meshes (the
  reference's rules run over a stand-in mesh: ``spec`` reads only its
  ``axis_names`` and ``devices.shape``);
* the op counter (``launch.hlo_analysis``) counts the reference's three
  matmul programs, written as Python loops, within the reference's 1%;
* the dry-run's ``dot_flops`` at ``scaled_config(..., 0.04)`` on one
  device equal the reference's HLO count of the jitted step within 2%
  (prefill, decode) and 5% (train);
* the CLI runs at production size on meta, and a cell the reference skips
  is skipped with its reason.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.shardings import MeshRules as JRules
from repro.launch import hlo_analysis as JH
from repro.launch import shapes as JS
from repro.launch.train import scaled_config as j_scaled_config
from repro.models import config as JC
from repro.models import model as JM
from repro.models import params as JP
from repro.optim import AdamW as JAdamW
from repro.optim import abstract_state as j_abstract_state
from repro.train import make_train_step as j_make_train_step
from repro_torch import tree as tree_util
from repro_torch.distributed.shardings import MeshRules
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import shapes as S
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.train import scaled_config
from repro_torch.models import config as C
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.optim import abstract_state

ARCHS = C.available()
MESHES = {"16x16": False, "2x16x16": True}


class _StandInMesh:
    """What the reference's ``MeshRules.spec`` reads of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(shape)


def _rules(multi_pod, **overrides):
    mesh = make_production_mesh(multi_pod=multi_pod)
    return (MeshRules.for_mesh(mesh, overrides),
            JRules.for_mesh(_StandInMesh(mesh.shape, mesh.axis_names),
                            overrides))


def _dt(x) -> str:
    return str(x).replace("torch.", "")


def _jleaves(tree):
    """(path, leaf) pairs of a reference tree, dict keys sorted."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif hasattr(t, "_fields"):            # AdamWState
            for k in t._fields:
                walk(getattr(t, k), path + (k,))
        else:
            out.append((path, t))

    walk(tree, ())
    return out


def _layout_entries(lay, path=()):
    for k in sorted(lay):
        e = lay[k]
        if isinstance(e, dict):
            yield from _layout_entries(e, path + (k,))
        else:
            yield path + (k,), e


def _local(shape, spec, sizes):
    out = []
    for d, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        out.append(d // int(np.prod([sizes[a] for a in axes])))
    return tuple(out)


# ---------------------------------------------------------------------------
# 1-3: rules, meshes, abstract trees
# ---------------------------------------------------------------------------
def test_production_meshes():
    m1, m2 = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (m1.shape, m1.axis_names, m1.size) == ((16, 16),
                                                  ("data", "model"), 256)
    assert (m2.shape, m2.axis_names, m2.size) == (
        (2, 16, 16), ("pod", "data", "model"), 512)
    assert make_mesh((4, 2), ("data", "model")).size == 8
    assert MeshRules.for_mesh(m2).num_devices() == 512
    assert MeshRules.single_device().spec((8, 8), ("batch", None)) == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_matches_reference_on_every_leaf(arch):
    """Every parameter, batch and cache leaf, on both production meshes,
    with the dry-run's two cache rules."""
    cfg, jcfg = C.get(arch), JC.get(arch)
    for multi in MESHES.values():
        for over in ({"cache_seq": None}, {"cache_seq": "model"}):
            rules, jrules = _rules(multi, **over)
            port = list(tree_util.leaves(P.param_defs(cfg)))
            ref = [p for _, p in _jleaves(JP.param_defs(jcfg))]
            assert len(port) == len(ref)
            for p, j in zip(port, ref):
                assert (p.shape, p.logical) == (j.shape, j.logical)
                assert rules.spec(p.shape, p.logical) == \
                    tuple(jrules.spec(j.shape, j.logical))
            enc = 4096 if cfg.family == "audio" else 0
            lay = dict(_layout_entries(M.cache_layout(cfg, 128, 4096, enc)))
            jlay = dict(_layout_entries(JM.cache_layout(jcfg, 128, 4096,
                                                        enc)))
            assert set(lay) == set(jlay)
            for k, (shape, _, logical) in lay.items():
                jshape, _, jlogical = jlay[k]
                assert (shape, logical) == (jshape, jlogical), k
                assert rules.spec(shape, logical) == \
                    tuple(jrules.spec(jshape, jlogical)), k
            for shape, logical in (((256, 4096), ("batch", "seq")),
                                   ((1, 4096), ("batch", "seq")),
                                   ((32, 1024, cfg.d_model),
                                    ("batch", "seq", "d_model")),
                                   ((128, 1), ("batch", None))):
                assert rules.spec(shape, logical) == \
                    tuple(jrules.spec(shape, logical))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_match_reference(arch):
    """abstract_params (both dtypes), param_specs, cache_spec and
    abstract_state: every leaf's shape and dtype, without rules and under
    each production mesh's rules (the local shape through the reference's
    spec)."""
    cfg, jcfg = C.get(arch), JC.get(arch)
    for dtype in (None, "bfloat16"):
        port = list(tree_util.leaves(P.abstract_params(cfg, dtype=dtype)))
        ref = [x for _, x in _jleaves(JP.abstract_params(jcfg, dtype=dtype))]
        assert [(tuple(p.shape), _dt(p.dtype)) for p in port] == \
            [(tuple(j.shape), str(j.dtype)) for j in ref]
        assert all(p.device.type == "meta" for p in port)
    jstate = _jleaves(j_abstract_state(JP.abstract_params(jcfg)))
    state = abstract_state(P.abstract_params(cfg))
    pstate = [state.count] + list(tree_util.leaves(state.m)) + list(
        tree_util.leaves(state.v))
    assert [(tuple(p.shape), _dt(p.dtype)) for p in pstate] == \
        [(tuple(j.shape), str(j.dtype)) for _, j in jstate]
    enc = 512 if cfg.family == "audio" else 0
    cache = _jleaves(JM.cache_spec(jcfg, 4, 512, enc_len=enc))
    assert [(tuple(x.shape), _dt(x.dtype)) for x in tree_util.leaves(
        M.cache_spec(cfg, 4, 512, enc_len=enc))] == \
        [(tuple(j.shape), str(j.dtype)) for _, j in cache]
    for multi in MESHES.values():
        rules, jrules = _rules(multi, cache_seq="model")
        sizes = rules.axis_sizes()
        jspecs = [s for _, s in _jleaves(JP.param_specs(jcfg, jrules))]
        assert list(tree_util.leaves(P.param_specs(cfg, rules))) == \
            [tuple(s) for s in jspecs]
        local = [tuple(p.shape) for p in tree_util.leaves(
            P.abstract_params(cfg, rules))]
        assert local == [_local(j.shape, s, sizes)
                         for j, s in zip(ref, jspecs)]
        st = abstract_state(P.abstract_params(cfg, rules))
        assert [tuple(x.shape) for x in tree_util.leaves(st.m)] == local
        jlay = dict(_layout_entries(JM.cache_layout(jcfg, 128, 4096, enc)))
        got = M.cache_spec(cfg, 128, 4096, rules, enc_len=enc)
        for k, x in _layout_entries(got):
            shape, _, logical = jlay[k]
            assert tuple(x.shape) == _local(
                shape, jrules.spec(shape, logical), sizes), k


CELLS = [(a, s) for a in ARCHS for s in JS.SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_shape_cell_matches_reference(arch, shape):
    """Skip verdict and reason, and every input's shape and dtype."""
    cfg, jcfg = C.get(arch), JC.get(arch)
    assert S.cell_supported(cfg, shape) == JS.cell_supported(jcfg, shape)
    assert S.SHAPES[shape] == S.ShapeCase(*dataclass_values(
        JS.SHAPES[shape]))
    assert S.TRAIN_ACCUM == JS.TRAIN_ACCUM
    assert S.SUBQUADRATIC == JS.SUBQUADRATIC
    if not S.cell_supported(cfg, shape)[0]:
        with pytest.raises(ValueError):
            S.input_specs(cfg, shape)
        return
    case = S.SHAPES[shape]
    assert S._frontend_splits(cfg, case) == JS._frontend_splits(
        jcfg, JS.SHAPES[shape])
    got = S.input_specs(cfg, shape)
    want = JS.input_specs(jcfg, shape)
    flat = [(k, x) for k, x in _layout_entries(got)]
    jflat = _jleaves(want)
    assert [k for k, _ in flat] == [k for k, _ in jflat]
    assert [(tuple(x.shape), _dt(x.dtype)) for _, x in flat] == \
        [(tuple(j.shape), str(j.dtype)) for _, j in jflat]


def dataclass_values(case):
    return (case.name, case.seq_len, case.global_batch, case.kind)


# ---------------------------------------------------------------------------
# 5: the op counter against the reference's three matmul programs
# ---------------------------------------------------------------------------
def _unrolled(k=4):
    def f(x, w):
        y = x
        for i in range(k):
            y = y @ w[i]
        return y
    return f, f, ((64, 128), (k, 128, 128))


def _scanned(k=16):
    def jf(x, w):
        def body(c, wl):
            return c @ wl, None
        return jax.lax.scan(body, x, w)[0]

    def f(x, w):
        for i in range(k):
            x = x @ w[i]
        return x
    return jf, f, ((64, 128), (k, 128, 128))


def _nested(k_out=3, k_in=5):
    def jf(x, w):
        def outer(c, wg):
            def inner(ci, wl):
                return ci @ wl, None
            return jax.lax.scan(inner, c, wg)[0], None
        return jax.lax.scan(outer, x, w)[0]

    def f(x, w):
        for i in range(k_out):
            for j in range(k_in):
                x = x @ w[i, j]
        return x
    return jf, f, ((32, 64), (k_out, k_in, 64, 64))


@pytest.mark.parametrize("program", [_unrolled, _scanned, _nested],
                         ids=["unrolled", "scanned", "nested"])
def test_op_counter_matches_reference_matmul_programs(program):
    jf, f, shapes = program()
    jargs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    ref = JH.analyze(jax.jit(jf).lower(*jargs).compile().as_text())
    got = H.analyze(f, *(torch.empty(s, device="meta") for s in shapes))
    assert abs(got["dot_flops"] - ref["dot_flops"]) <= 0.01 * ref["dot_flops"]
    assert got["flops"] == got["dot_flops"]
    assert got["hbm_bytes"] > 0 and got["peak_bytes"] > 0


def test_op_counter_peak_counts_live_storages():
    """Views share their base, saved activations stay live until the
    backward frees them, the step's own outputs count once."""
    x = torch.empty(256, 256, device="meta")
    w = torch.empty(256, 256, device="meta", requires_grad=True)
    mb = 256 * 256 * 4

    def step():
        y = torch.tanh(x @ w)           # x @ w (temp), tanh (saved)
        z = y.t()[0:128]                # views: no new bytes
        loss = (z * 2.0).sum()
        return torch.autograd.grad(loss, [w])

    got = H.analyze(step)
    assert 3 * mb <= got["peak_bytes"] <= 5 * mb
    assert H.collective_wire("all-reduce", 512, 4) == 2 * 512 * 3 / 4
    assert H.collective_wire("reduce-scatter", 512, 4) == 512 * 3
    assert H.collective_wire("collective-permute", 512, 1) == 512


# ---------------------------------------------------------------------------
# 6: the dry-run against the reference
# ---------------------------------------------------------------------------
def _reference_dryrun():
    """``repro.launch.dryrun`` without its import-time device flag leaking
    into this process's later subprocesses."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


def test_model_flops_match_reference():
    jd = _reference_dryrun()
    for arch, shape in CELLS:
        assert D._model_flops(C.get(arch), S.SHAPES[shape]) == \
            jd._model_flops(JC.get(arch), JS.SHAPES[shape]), (arch, shape)


def _reference_dot_flops(jcfg, kind, case):
    rules = JRules.single_device()
    if kind == "train":
        step = j_make_train_step(jcfg, rules, JAdamW(learning_rate=1e-3),
                                 accum=1)
        params = JP.abstract_params(jcfg)
        args = (params, j_abstract_state(params),
                JS.train_specs(jcfg, case))
    elif kind == "prefill":
        def step(params, batch):
            return JM.prefill(jcfg, rules, params, batch)
        args = (JP.abstract_params(jcfg, dtype="bfloat16"),
                JS.prefill_specs(jcfg, case))
    else:
        def step(params, cache, tokens):
            return JM.decode_step(jcfg, rules, params, cache, tokens)
        spec = JS.decode_specs(jcfg, case)
        args = (JP.abstract_params(jcfg, dtype="bfloat16"), spec["cache"],
                spec["tokens"])
    text = jax.jit(step).lower(*args).compile().as_text()
    return JH.analyze(text)["dot_flops"]


DOT_CASES = [(a, k) for a in ("qwen3-0.6b", "phi3.5-moe-42b-a6.6b",
                              "zamba2-7b")
             for k in ("prefill", "decode", "train")]
DOT_TOL = {"prefill": 0.02, "decode": 0.02, "train": 0.05}


@pytest.mark.parametrize("arch,kind", DOT_CASES,
                         ids=[f"{a}-{k}" for a, k in DOT_CASES])
def test_dot_flops_match_reference_hlo(arch, kind):
    cfg = scaled_config(C.get(arch), 0.04)
    jcfg = j_scaled_config(JC.get(arch), 0.04)
    case = S.ShapeCase("small", 64, 2, kind)
    jcase = JS.ShapeCase("small", 64, 2, kind)
    rec, _ = D.lower_cell(cfg, case, rules=MeshRules.single_device(),
                          accum=1)
    ref = _reference_dot_flops(jcfg, kind, jcase)
    got = rec["per_device"]["dot_flops"]
    assert abs(got - ref) <= DOT_TOL[kind] * ref, (got, ref)
    assert rec["chips"] == 1 and rec["kind"] == kind


def _record_ok(rec):
    assert "error" not in rec and "skipped" not in rec, rec
    pd, rl = rec["per_device"], rec["roofline"]
    for k in ("flops", "bytes_accessed", "peak_bytes", "temp_bytes"):
        assert np.isfinite(pd[k]) and pd[k] > 0, k
    first = "compute_vpu_s" if rec["kind"] == "nbody" else "compute_s"
    terms = [rl[k] for k in (first, "memory_s", "collective_s")]
    assert rl["step_time_s"] == max(terms)
    assert "xla_flops_body_once" not in pd
    assert set(rec["timings"]) == {"trace_s"}


def test_cli_runs_production_cells_on_meta(tmp_path):
    out = str(tmp_path)
    D.main(["--arch", "qwen3-0.6b", "--shape", "train_4k", "--out", out])
    D.main(["--arch", "xlstm-1.3b", "--shape", "long_500k", "--out", out])
    D.main(["--nbody", "--strategy", "ring", "--n-particles", "409600",
            "--out", out])
    train = json.load(open(tmp_path / "qwen3-0.6b__train_4k__16x16.json"))
    _record_ok(train)
    assert train["chips"] == 256 and train["accum"] == 2
    assert train["per_device"]["collectives"]["counts"]["all-gather"] > 0
    long = json.load(open(tmp_path / "xlstm-1.3b__long_500k__16x16.json"))
    _record_ok(long)
    ring = json.load(open(tmp_path / "nbody-ring__N409600__16x16.json"))
    _record_ok(ring)
    pd = ring["per_device"]
    # one slot's work: 256 rounds of one K1 and one K2 launch, each over
    # the slot's 1600 targets (padded to 1792) and a 2048-source window
    assert pd["kernel_launches"] == {"acc_jerk_pot": 256, "snap": 256}
    assert pd["flops"] >= (43 + 62) * 256 * 1792 * 2048
    assert pd["collectives"]["counts"]["collective-permute"] == 2 * 255
    # the mesh's methods are put back as they were
    from repro_torch.core import strategies

    assert isinstance(strategies.DeviceMesh.__dict__["_gather_group"],
                      staticmethod)


def test_skipped_cell_gives_the_reference_reason(tmp_path, capsys):
    rec = D.run_cell("qwen3-0.6b", "long_500k", multi_pod=False,
                     out_dir=str(tmp_path))
    assert rec["skipped"] == JS.cell_supported(JC.get("qwen3-0.6b"),
                                               "long_500k")[1]
    assert "SKIP" in capsys.readouterr().out
    assert json.load(open(tmp_path / "qwen3-0.6b__long_500k__16x16.json")) \
        == rec


def test_kernel_targets_follow_the_kernels_tiling():
    """The streamed-bytes model's targets per block are K1's and K2's."""
    import re

    from repro_torch.kernels import _build, bounds

    src = (_build.CSRC / "nbody_force.cu").read_text()
    for prefix in ("kAcc", "kSnap"):
        def const(name):
            return int(re.findall(rf"constexpr int {prefix}{name} = (\d+);",
                                  src)[0])
        assert const("Threads") // const("Slices") * const("Per") == \
            bounds.KERNEL_TARGETS


def test_local_config_keeps_valid_head_groups():
    """One device's share of each config is a config the model runs: the
    local query heads a multiple of the local kv heads, the widths the
    rules' shares."""
    for multi in MESHES.values():
        rules, _ = _rules(multi, cache_seq="model")
        for arch in ARCHS:
            cfg = C.get(arch)
            loc = D.local_config(cfg, rules)
            assert loc.n_heads % loc.n_kv_heads == 0, arch
            assert loc.head_dim == cfg.head_dim
            assert loc.padded_vocab * 16 == cfg.padded_vocab
            if cfg.n_experts:
                assert loc.n_experts * loc.top_k <= cfg.n_experts * \
                    cfg.top_k


def test_kernel_meta_launches_count_their_formulas():
    """K3 on meta tallies both products in dot_flops; K1/K2 their pair
    terms in flops only; expanded, each runs its plain version op by op."""
    from repro_torch.kernels import bounds, flash_attention, nbody_force

    q = torch.empty(2, 256, 4, 32, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 256, 2, 32, dtype=torch.bfloat16, device="meta")
    got = H.analyze(flash_attention.flash_attention, q, k, k, block_q=128,
                    block_k=128)
    assert got["dot_flops"] == bounds.attn_flops(2, 256, 256, 4, 32, True)
    assert got["kernels"] == {"flash_attention": 1}
    assert got["hbm_bytes"] == bounds.attn_bytes(2, 256, 256, 4, 2, 32, 2)
    tgt = torch.empty(512, 8, device="meta")
    src = torch.empty(8, 1024, device="meta")
    got = H.analyze(nbody_force.acc_jerk_pot_packed, tgt, src)
    assert got["dot_flops"] == 0 and got["kernels"] == {"acc_jerk_pot": 1}
    assert got["flops"] == 43 * 512 * 1024
    # targets and output once, the sources once per block of 128 targets
    assert got["hbm_bytes"] == 32 * (512 + 4 * 1024 + 512)
    plain = H.analyze(nbody_force.acc_jerk_pot_packed, tgt, src,
                      expand_kernels=True)
    assert plain["kernels"] == {} and plain["ops"] > 10


@pytest.mark.parametrize("arch", ("deepseek-v2-236b", "zamba2-7b"))
def test_grads_only_cell_is_the_step_without_the_optimizer(arch):
    """``lower_cell(..., grads_only=True)`` counts ``_value_and_grad``
    alone: the train step's products (AdamW has none), none of the
    optimizer state in the stored bytes, a lower peak; a serve cell or
    microbatching is refused."""
    cfg = scaled_config(C.get(arch), 0.04)
    case = S.ShapeCase("small", 64, 2, "train")
    single = MeshRules.single_device()
    full, _ = D.lower_cell(cfg, case, rules=single, accum=1)
    alone, _ = D.lower_cell(cfg, case, rules=single, accum=1,
                            grads_only=True)
    fp, gp = full["per_device"], alone["per_device"]
    assert gp["dot_flops"] == fp["dot_flops"]
    assert gp["flops"] < fp["flops"]
    opt_bytes = H.tensor_bytes(abstract_state(P.abstract_params(cfg)))
    assert gp["argument_bytes"] == fp["argument_bytes"] - opt_bytes
    assert gp["peak_bytes"] < fp["peak_bytes"]
    _record_ok(alone)
    with pytest.raises(ValueError, match="grads_only"):
        D.lower_cell(cfg, S.ShapeCase("small", 64, 2, "prefill"),
                     rules=single, grads_only=True)
    with pytest.raises(ValueError, match="grads_only"):
        D.lower_cell(cfg, case, rules=single, accum=2, grads_only=True)
