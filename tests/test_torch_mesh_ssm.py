"""Port parity: the ssm (xLSTM: mLSTM and sLSTM blocks) and hybrid (Mamba2
with one shared attention block) families over a real device mesh, four
gloo ranks on the CPU as a (data=2, model=2) mesh, against the reference
on a (2, 2) ``jax.sharding.Mesh`` of four forced host devices and against
the port's single-device run of the same jobs (``distributed.mesh_runs``),
with gradient accumulation and int8 compression under the mesh.

One module-scoped spawn of four ranks runs every mesh job while two
subprocesses, one per family, run the reference's meshed prefill and
``Engine`` and, as ``chip_smoke.py`` phase 23 trains them, the hybrid
configs' ``Trainer`` with ``TrainerConfig(accum=2)`` and the xLSTM
configs' ``make_train_step`` with ``accum=2`` and int8 compression, on
the same parameters (the port's ``init_params`` from a seed, carried to
both packages as numpy; ``params_from_jax``) and batches; a spawn of two
ranks, a (1, 2) mesh, then runs the elastic restores and the planted
faults.  The configs are tiny: a hybrid (d 64,
8 SSM heads of 16, the shared block after every second of 5 layers, so a
tail layer follows), an xLSTM (d 64, 4 heads, an sLSTM block every second
of 4 layers), and the two fallbacks where "heads" does not divide the
model axis while "d_ff" does: a hybrid of 3 SSM heads (d 48, head dim
32) and an xLSTM of 3 heads (d 48).  Held, each at ``REL`` (fp32,
relative to the largest element):

* every parameter's placements and local shape equal ``MeshRules``'s, and
  ``param_specs`` on the real mesh equal the reference's, for the tiny
  configs and for zamba2-7b and xlstm-1.3b at full width;
* the meshed prefill logits against the single-device run's and the
  reference's meshed prefill, and the greedy tokens of four decode steps
  equal on every rank, to the single-device run's and to the reference's
  (the hybrid through the flash route too, its plain version here); two
  meshed prefills give the same bits;
* the recurrent states, carries and conv cache placed by their logical
  axes;
* every gradient of one step against the single-device run's, placed as
  its parameter;
* the hybrid configs: two ``Trainer`` steps with ``accum = 2``, the
  labels masked unevenly between the microbatches (a rank's own rows as
  its microbatch would be another function), against the reference's
  meshed ``Trainer`` and one device; the xLSTM configs: one
  ``make_train_step`` step with ``accum = 2`` and ``grad_compression=
  "int8"`` against the reference's under its mesh and one device, the
  error buffers placed as the parameters;
* the elastic restore, bit for bit: saved on one device, restored on the
  (2, 2) mesh; saved on the (2, 2) mesh, restored on a (1, 2) mesh of two
  ranks and on one device;
* two planted faults read outside ``REL``: the mLSTM's up-projection
  halved on each rank's block (a local ``torch.chunk``), and an RMS norm
  taken per rank over a row the mesh splits (Mamba2's gated norm).
"""

import concurrent.futures
import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.distributed import mesh_runs, process_mesh
from repro_torch.distributed.shardings import MeshRules
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import config as C
from repro_torch.models import layers, model
from repro_torch.models import params as P
from repro_torch.models.config import ArchConfig

#: 8 SSM heads of 16 (d_inner 128); the shared block after layers 1 and 3,
#: layer 4 the tail
HYBRID = dict(name="hybrid-small", family="hybrid", n_layers=5, d_model=64,
              n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
              dtype="float32", ssm_state=16, ssm_head_dim=16, attn_every=2,
              chunk_size=8)
#: 4 heads: mLSTM, sLSTM, mLSTM, sLSTM
XLSTM = dict(name="xlstm-small", family="ssm", n_layers=4, d_model=64,
             n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=256,
             dtype="float32", slstm_every=2, chunk_size=8,
             tie_embeddings=True)
#: the fallbacks: 3 heads on a model axis of 2 stay whole, "d_ff" splits
HYBRID3 = dict(HYBRID, name="hybrid-3heads", d_model=48, ssm_head_dim=32,
               n_layers=3)
XLSTM3 = dict(XLSTM, name="xlstm-3heads", d_model=48, n_heads=3,
              n_kv_heads=3, n_layers=2)
FAMILIES = {"hybrid": HYBRID, "xlstm": XLSTM, "hybrid3": HYBRID3,
            "xlstm3": XLSTM3}
#: how each config trains: the Trainer with accum, or make_train_step with
#: accum and int8 (chip_smoke.py phase 23's split)
TRAIN = {"hybrid": "trainer", "hybrid3": "trainer", "xlstm": "int8",
         "xlstm3": "int8"}
#: restored across 4, 2 and 1 ranks
RESTORED = ("hybrid", "xlstm")
REGISTERED = ("zamba2-7b", "xlstm-1.3b")
MESH = (2, 2)
B, S, GEN, MAX_LEN = 4, 16, 4, 24
STEPS, LR, ACCUM = 2, 1e-3, 2
#: the share of each microbatch's labels masked out: unequal, so that
#: each microbatch's mean over its own labels differs from a mean over
#: any other split of the rows
MASKED = (0.5, 0.1)
#: fp32, relative: the mesh sums its products in another order (measured
#: <= 2.1e-6 on the logits and the gradients)
REL = 1e-5
#: after Adam's steps, the parameters: |mesh - want| <= STEP_ATOL +
#: STEP_RTOL |want| but for a share FLIP_SHARE of all elements, each within
#: 4 LR (tests/test_torch_train.py's bound for accumulation and int8).
#: An element whose gradient lies within fp32 noise of 0 takes a step of
#: another size: the sLSTM's bias, zero at the start, has a gate whose
#: gradient is 1e-4 of the leaf's largest (128 of its 512 elements part by
#: up to 2.7e-5 after two steps, 8e-4 of the tree)
STEP_ATOL, STEP_RTOL, FLIP_SHARE = 5e-5, 1e-3, 1e-3
#: int8: the share of error-feedback residuals more than 1e-3 of their
#: leaf's largest apart (tests/test_torch_train.py): a residual moves with
#: 127 times its gradient's noise, and a flip by a whole level
RESIDUAL_SHARE = 5e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor operations: one thread per test worker, for the
    module's fixtures too (idle pool threads spin and starve the other
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg["vocab_size"], (B, S)).astype(np.int32)
    data, mb = [], B // ACCUM
    for _ in range(STEPS):
        labels = rng.integers(0, cfg["vocab_size"], (B, S)).astype(np.int32)
        for i, share in enumerate(MASKED):
            rows = labels[i * mb:(i + 1) * mb]
            rows[rng.uniform(size=rows.shape) < share] = -1
        data.append({"labels": labels, "tokens": rng.integers(
            0, cfg["vocab_size"], (B, S)).astype(np.int32)})
    params = tree_util.map(lambda t: t.numpy(), P.init_params(
        ArchConfig(**cfg), torch.Generator().manual_seed(seed),
        device="cpu"))
    return dict(cfg=cfg, params=params, tokens=tokens, data=data)


_JAX_MESH = textwrap.dedent(r"""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.distributed import compression
    from repro.distributed.shardings import MeshRules
    from repro.models import config as JC
    from repro.models import params as P
    from repro.models.config import ArchConfig
    from repro.optim import AdamW
    from repro.serve.engine import Engine, ServeConfig
    from repro.train import Trainer, TrainerConfig
    from repro.train.step import make_train_step

    inp = pickle.load(open(sys.argv[1], "rb"))
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    rules = MeshRules.for_mesh(mesh)

    def specs(cfg):
        return jax.tree.map(
            tuple, P.param_specs(cfg, rules),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))

    def host(tree):
        return jax.tree.map(np.asarray, tree)

    out = {"specs": {n: specs(JC.get(n)) for n in inp["registered"]}}
    for key, fam in inp["families"].items():
        cfg = ArchConfig(**fam["cfg"])
        out["specs"][cfg.name] = specs(cfg)

        def placed():
            # the Trainer donates its parameters: a fresh copy per use
            return jax.tree.map(jax.device_put,
                                jax.tree.map(jnp.asarray, fam["params"]),
                                P.param_shardings(cfg, rules))

        params = placed()
        batch = {"tokens": jnp.asarray(fam["tokens"])}
        eng = Engine(cfg, rules, params, ServeConfig(max_len=inp["max_len"]))
        logits, _ = eng._prefill(params, batch, max_len=inp["max_len"])
        toks, _ = eng.generate(batch, inp["gen"])
        out[key] = {"logits": np.asarray(logits), "tokens": np.asarray(toks)}
        data = fam["data"]
        opt = AdamW(learning_rate=inp["lr"])
        start = placed()
        if fam["train"] == "trainer":
            tr = Trainer(cfg, rules, opt, lambda step: data[step],
                         TrainerConfig(steps=len(data), accum=inp["accum"],
                                       log_every=10 ** 9),
                         log=lambda _m: None)
            p2, _, hist = tr.run(start_params=start,
                                 start_opt=opt.init(start))
            out[key]["train"] = {"loss": np.array([h["loss"] for h in hist]),
                                 "params": host(p2)}
        else:
            step = jax.jit(make_train_step(cfg, rules, opt,
                                           accum=inp["accum"],
                                           grad_compression="int8"))
            p3, _, met, err = step(
                start, opt.init(start),
                {k: jnp.asarray(v) for k, v in data[0].items()},
                compression.zeros_error(start))
            out[key]["int8"] = {"loss": np.array([float(met["loss"])]),
                                "params": host(p3), "err": host(err)}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _reference(tmp, inp, registered=()):
    """The reference on a (2, 2) mesh of four forced host devices, for the
    configs of ``inp``: their prefill, tokens and training (``TRAIN``),
    and the ``param_specs`` of theirs and of ``registered``."""
    tag = "_".join(inp)
    src = os.path.join(tmp, f"ref_in_{tag}.pkl")
    dst = os.path.join(tmp, f"ref_out_{tag}.pkl")
    inp = {k: dict(v, train=TRAIN[k]) for k, v in inp.items()}
    with open(src, "wb") as f:
        pickle.dump(dict(families=inp, registered=registered, lr=LR,
                         max_len=MAX_LEN, gen=GEN, accum=ACCUM), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    res = subprocess.run([sys.executable, "-c", _JAX_MESH, src, dst],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(dst, "rb") as f:
        return pickle.load(f)


# --------------------------------------------------------------------------
# the planted faults, run by the ranks of the two-rank spawn
# --------------------------------------------------------------------------
def _local_halves(rules, up):
    """Fault: the mLSTM's up-projection halved on each rank's block of
    "d_ff" (a local ``torch.chunk``): on model = 2, rank 0's xm and zg are
    both halves of xm, rank 1's both halves of zg."""
    from torch.distributed.tensor.experimental import local_map
    pl = list(up.placements)
    return local_map(lambda u: tuple(torch.chunk(u, 2, dim=-1)),
                     out_placements=(pl, pl), in_placements=(pl,),
                     device_mesh=rules.mesh)(up)


def _rms_per_rank(norm):
    """Fault: an RMS norm over a row the mesh splits taken on each rank's
    part of it alone (Mamba2's gated norm over the split d_inner)."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import local_map

    def fault(x, w, eps=1e-5):
        if not (isinstance(x, DTensor) and Shard(x.ndim - 1) in x.placements):
            return norm(x, w, eps)
        return local_map(lambda a, b: norm(a, b, eps),
                         out_placements=list(x.placements),
                         in_placements=(list(x.placements),
                                        list(w.placements)),
                         device_mesh=x.device_mesh)(x, w)
    return fault


@contextlib.contextmanager
def _planted(fault):
    saved = model._halves, layers.rms_norm
    if fault == "local_chunk":
        model._halves = _local_halves
    elif fault == "rms_per_rank":
        layers.rms_norm = _rms_per_rank(layers.rms_norm)
    try:
        yield
    finally:
        model._halves, layers.rms_norm = saved


def planted_rank(device, jobs, out_dir):
    """``mesh_runs.lm_rank`` with each job's ``fault`` planted while it
    runs."""
    run = mesh_runs.run_lm_job

    def one(job, dev, meshes):
        with _planted(job.get("fault")):
            return run({k: v for k, v in job.items() if k != "fault"}, dev,
                       meshes)

    mesh_runs.run_lm_job = one
    mesh_runs.lm_rank(device, jobs, out_dir)


#: the planted faults: the config each shows on
FAULTS = {"local_chunk": "xlstm", "rms_per_rank": "hybrid"}


def _jobs(inp, one_dir, mesh_dir, mesh):
    """Per family: placements, serve (the hybrid through the flash route
    too), grads, and its training (``TRAIN``: two accumulated Trainer
    steps, or one accumulated int8 step), saving a checkpoint for the
    families of RESTORED in ``mesh_dir`` (``mesh``) or ``one_dir`` (one
    device)."""
    jobs, index = [], {}

    def add(key, job):
        index[key] = len(jobs)
        jobs.append(job)

    for name, fam in inp.items():
        cfg = ArchConfig(**fam["cfg"])
        common = dict(cfg=cfg, params=fam["params"])
        add(("placements", name), dict(common, kind="placements",
                                       spec_cfgs=[cfg]))
        serve = dict(common, kind="serve", tokens=fam["tokens"],
                     max_len=MAX_LEN, gen=GEN, repeat=1)
        add(("serve", name), serve)
        if cfg.family == "hybrid" and name == "hybrid":
            add(("serve_flash", name), dict(
                serve, cfg=dataclasses.replace(cfg, attn_impl="flash")))
        add(("grads", name), dict(common, kind="grads", data=fam["data"]))
        ckpt = mesh_dir if mesh else one_dir
        train = dict(common, data=fam["data"], accum=ACCUM, moments=True,
                     opt={"learning_rate": LR},
                     ckpt_dir=(os.path.join(ckpt, name) if name in RESTORED
                               else None))
        if TRAIN[name] == "trainer":
            add(("train", name), dict(train, kind="train", steps=STEPS))
        else:
            add(("train", name), dict(train, kind="step", steps=1,
                                      grad_compression="int8"))
    add(("specs", "registered"), dict(
        kind="placements", cfg=ArchConfig(**XLSTM),
        params=inp["xlstm"]["params"],
        spec_cfgs=[C.get(n) for n in REGISTERED]))
    for name in RESTORED:
        add(("restore", name), dict(kind="restore",
                                    cfg=ArchConfig(**inp[name]["cfg"]),
                                    opt={"learning_rate": LR},
                                    ckpt_dir=os.path.join(one_dir, name)))
    return [dict(j, mesh=mesh) for j in jobs], index


def _two_jobs(inp, mesh_dir):
    """The (1, 2) mesh's jobs: the restores of the (2, 2) mesh's
    checkpoints, then each planted fault's prefill beside the sound one."""
    jobs = [dict(kind="restore", cfg=ArchConfig(**inp[name]["cfg"]),
                 opt={"learning_rate": LR},
                 ckpt_dir=os.path.join(mesh_dir, name), mesh=(1, 2))
            for name in RESTORED]
    for fault, name in FAULTS.items():
        serve = dict(kind="serve", cfg=ArchConfig(**inp[name]["cfg"]),
                     params=inp[name]["params"], tokens=inp[name]["tokens"],
                     max_len=MAX_LEN, gen=1, mesh=(1, 2))
        jobs += [serve, dict(serve, fault=fault)]
    return jobs


def _spawn(world, fn, jobs):
    out = tempfile.mkdtemp(prefix="mesh_ssm_")
    process_mesh.spawn(fn, world, "gloo", "cpu", jobs, out)
    return mesh_runs.load_ranks(out, world)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's meshed run (a subprocess) while four ranks run the
    jobs on the (2, 2) mesh; the single-device run of the same jobs (first:
    the mesh restores its checkpoints); then two ranks on (1, 2) and one
    device restore the mesh's checkpoints, and the (1, 2) mesh runs the
    planted faults."""
    tmp = str(tmp_path_factory.mktemp("mesh_ssm"))
    one_dir, mesh_dir = os.path.join(tmp, "one"), os.path.join(tmp, "mesh")
    inp = {name: _inputs(cfg, seed)
           for seed, (name, cfg) in enumerate(FAMILIES.items())}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        refs = [pool.submit(_reference, tmp, {k: v for k, v in inp.items()
                                              if TRAIN[k] == kind}, reg)
                for kind, reg in (("trainer", ()), ("int8", REGISTERED))]
        jobs, index = _jobs(inp, one_dir, mesh_dir, None)
        n_one = index[("specs", "registered")]
        one = mesh_runs.in_process_lm("cpu", jobs[:n_one])
        four = _spawn(4, mesh_runs.lm_rank,
                      _jobs(inp, one_dir, mesh_dir, MESH)[0])
        two = _spawn(2, planted_rank, _two_jobs(inp, mesh_dir))
        back = mesh_runs.in_process_lm("cpu", [
            dict(kind="restore", cfg=ArchConfig(**inp[name]["cfg"]),
                 opt={"learning_rate": LR},
                 ckpt_dir=os.path.join(mesh_dir, name))
            for name in RESTORED])
        ref = refs[0].result()
        for r in refs[1:]:
            more = r.result()
            ref["specs"].update(more.pop("specs"))
            ref.update(more)
        return dict(inp=inp, index=index, ref=ref, one=one, four=four,
                    two=two, back=back)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _flat(tree, leaf=np.asarray, prefix=""):
    """{path: leaf(x)} over a tree of dicts."""
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], leaf, path))
        else:
            out[path] = leaf(tree[k])
    return out


def _res(runs, kind, name):
    """One device's result of a job (None for a job of the mesh alone)
    and every rank's."""
    i = runs["index"][(kind, name)]
    one = runs["one"][i] if i < len(runs["one"]) else None
    return one, [r[i] for r in runs["four"]]


def _leaves(tensors, prefix):
    return {k[len(prefix):]: v for k, v in tensors.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_placements_follow_the_rules(runs, name):
    """Every leaf's placements and local shape on every rank equal
    ``MeshRules.placements`` and ``local_shape`` of its logical axes."""
    _, four = _res(runs, "placements", name)
    for r, res in enumerate(four):
        assert res["info"]["layout"] == res["info"]["want"], r
    layout = four[0]["info"]["layout"]
    # (placements per mesh axis, data then model; the layers stacked first)
    if name == "hybrid":   # SSM heads and d_ff on "model"
        assert layout["blocks/a_log"] == (("R", "S(1)"), (5, 4))
        assert layout["blocks/wx"] == (("S(1)", "S(2)"), (5, 32, 64))
    if name == "hybrid3":  # 3 heads stay whole; d_ff still splits
        for leaf in ("a_log", "d_skip", "dt_bias"):
            assert layout[f"blocks/{leaf}"] == (("R", "R"), (3, 3)), leaf
        assert layout["blocks/wdt"] == (("S(1)", "R"), (3, 24, 3))
        for leaf in ("wx", "wz"):
            assert layout[f"blocks/{leaf}"] == (("S(1)", "S(2)"),
                                                (3, 24, 48)), leaf
        assert layout["blocks/conv"] == (("R", "S(2)"), (3, 4, 48))
        assert layout["blocks/gnorm"] == (("R", "S(1)"), (3, 48))
    if name == "xlstm3":
        for leaf in ("wq", "wk", "wv"):
            assert layout[f"blocks/{leaf}"][0] == ("R", "R"), leaf
        assert layout["blocks/w_up"] == (("S(1)", "S(2)"), (1, 24, 96))
        assert layout["blocks/onorm"] == (("R", "S(1)"), (1, 48))


@pytest.mark.parametrize("name", [FAMILIES[n]["name"] for n in FAMILIES]
                         + list(REGISTERED))
def test_param_specs_equal_the_reference(runs, name):
    key = next((k for k, c in FAMILIES.items() if c["name"] == name), None)
    job = ("placements", key) if key else ("specs", "registered")
    got = _res(runs, *job)[1][0]["info"]["specs"][name]
    want = _flat(runs["ref"]["specs"][name], leaf=tuple)
    assert {k: tuple(v) for k, v in got.items()} == want


SERVE_CASES = [("serve", n) for n in FAMILIES] + [("serve_flash", "hybrid")]


@pytest.mark.parametrize("kind,name", SERVE_CASES)
def test_meshed_prefill_and_greedy_tokens(runs, kind, name):
    """Prefill logits within REL of the single-device run and of the
    reference's meshed prefill; the greedy tokens equal everywhere; a
    second meshed prefill the same bits."""
    one, four = _res(runs, kind, name)
    ref = runs["ref"][name]
    for r, res in enumerate(four):
        got = res["tensors"]
        assert _rel(got["logits"], one["tensors"]["logits"]) <= REL, r
        assert _rel(got["logits"], ref["logits"]) <= REL, r
        assert torch.equal(got["tokens"], one["tensors"]["tokens"]), r
        np.testing.assert_array_equal(got["tokens"].numpy(), ref["tokens"])
        assert res["info"]["prefills_equal"] is True, r


@pytest.mark.parametrize("name", list(FAMILIES))
def test_cache_is_placed_by_its_logical_axes(runs, name):
    """The SSM states on ("cache_batch", "heads"), the conv cache on
    ("cache_batch", "d_ff"), the shared block's KV as the dense KV, the
    mLSTM's (C, n, m) and the sLSTM's carry on ("cache_batch", "heads"):
    split on "heads" where it divides the model axis, whole on it where it
    does not (the fallbacks), on every rank; the engine's weights, cast
    for serving, placed as the parameters."""
    cfg = ArchConfig(**FAMILIES[name])
    rules = MeshRules.for_mesh(make_mesh(MESH, ("data", "model")))
    want = {}

    def walk(lay, prefix=""):
        for k, e in lay.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(e, dict):
                walk(e, path)
            elif e[1] is not int:
                want[path] = (tuple(str(p) for p in rules.placements(
                    e[0], e[2])), rules.local_shape(e[0], e[2]))
    walk(model.cache_layout(cfg, B, MAX_LEN))
    _, four = _res(runs, "serve", name)
    placed = _res(runs, "placements", name)[1][0]["info"]["want"]
    for r, res in enumerate(four):
        assert res["info"]["cache_leaves"] == want, r
        # the engine's cast (the fp32 leaves to fp32) keeps each placement
        assert res["info"]["layout"] == placed, r
    got = four[0]["info"]["cache_leaves"]
    whole = name.endswith("3")          # the heads stay whole on "model"
    if cfg.family == "hybrid":
        assert got["ssm"][0] == ("S(1)", "R" if whole else "S(2)")
        assert got["conv"][0] == ("S(1)", "S(3)")
        assert got["attn/k"][0] == ("S(1)", "S(3)")
    else:
        for leaf in ("mlstm_C", "mlstm_n", "mlstm_m", "slstm"):
            assert got[leaf][0] == ("S(2)", "R" if whole else "S(3)"), leaf


@pytest.mark.parametrize("name", list(FAMILIES))
def test_meshed_gradients_match_one_device(runs, name):
    """Every gradient on the mesh within REL of the one-device run's,
    placed as its parameter (a partial sum left unreduced, or a norm over
    one rank's part of a row, shows here)."""
    one, four = _res(runs, "grads", name)
    layout = _res(runs, "placements", name)[1][0]["info"]["layout"]
    for r, res in enumerate(four):
        got = res["tensors"]
        assert _rel(got["loss"], one["tensors"]["loss"]) <= REL, r
        for key, want in one["tensors"].items():
            if key.startswith("grad."):
                assert _rel(got[key], want) <= REL, (r, key)
        assert res["info"]["layout"] == layout, r


def _assert_steps_close(got: dict, want: dict):
    """tests/test_torch_train.py's bound on parameters after Adam steps:
    at most FLIP_SHARE of the elements outside STEP_ATOL + STEP_RTOL
    |want|, each within 4 LR."""
    assert set(got) == set(want)
    n = off = 0
    for name, w in want.items():
        g = np.asarray(got[name], np.float64)
        w = np.asarray(w, np.float64)
        excess = np.abs(g - w) - (STEP_ATOL + STEP_RTOL * np.abs(w))
        n, off = n + excess.size, off + int((excess > 0).sum())
        assert excess.max() <= 4 * LR, name
    assert off <= FLIP_SHARE * n, (off, n)


HYBRIDS = [n for n in FAMILIES if TRAIN[n] == "trainer"]
XLSTMS = [n for n in FAMILIES if TRAIN[n] == "int8"]


@pytest.mark.parametrize("name", HYBRIDS)
def test_accumulated_trainer_steps_match_the_reference_and_one_device(
        runs, name):
    """Two ``Trainer`` steps with ``accum = 2``: the losses within REL of
    the reference's meshed ``Trainer`` and of one device, the parameters
    by the steps' bound, the moments placed as the parameters.  Each
    microbatch is rows of the global batch, whose masks differ."""
    one, four = _res(runs, "train", name)
    ref = runs["ref"][name]["train"]
    ref_params = _flat(ref["params"])
    for r, res in enumerate(four):
        t = res["tensors"]
        assert _rel(t["loss"], ref["loss"]) <= REL, r
        assert _rel(t["loss"], one["tensors"]["loss"]) <= REL, r
        got = _leaves(t, "params.")
        _assert_steps_close(got, ref_params)
        _assert_steps_close(got, _leaves(one["tensors"], "params."))
        assert res["info"]["opt_layout"] == res["info"]["layout"], r


def _assert_residuals_close(got: dict, want: dict):
    assert set(got) == set(want)
    far = []
    for name, w in want.items():
        g = np.asarray(got[name], np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape and np.isfinite(g).all(), name
        far.append((np.abs(g - w) > 1e-3 * np.abs(w).max()).ravel())
    assert np.concatenate(far).mean() <= RESIDUAL_SHARE


@pytest.mark.parametrize("name", XLSTMS)
def test_accumulated_int8_step_matches_the_reference_and_one_device(
        runs, name):
    """One ``make_train_step`` step with ``accum = 2`` and
    ``grad_compression="int8"``: the loss within REL of the reference's
    under its mesh and of one device, the parameters by the steps' bound
    and the error-feedback residuals by RESIDUAL_SHARE (the scale is each
    leaf's whole max: a rank's own max would move every residual of the
    leaf), the residuals placed as the parameters."""
    one, four = _res(runs, "train", name)
    ref = runs["ref"][name]["int8"]
    for r, res in enumerate(four):
        t = res["tensors"]
        assert _rel(t["loss"], ref["loss"]) <= REL, r
        assert _rel(t["loss"], one["tensors"]["loss"]) <= REL, r
        got = _leaves(t, "params.")
        _assert_steps_close(got, _flat(ref["params"]))
        _assert_steps_close(got, _leaves(one["tensors"], "params."))
        err = _leaves(t, "err.")
        _assert_residuals_close(err, _flat(ref["err"]))
        _assert_residuals_close(err, _leaves(one["tensors"], "err."))
        assert res["info"]["err_layout"] == res["info"]["layout"], r


def _restored(res):
    return {k: v for k, v in res["tensors"].items()
            if k.startswith(("params.", "m."))}


@pytest.mark.parametrize("name", RESTORED)
def test_elastic_restore_bit_for_bit(runs, name):
    """Saved on one device, restored on the (2, 2) mesh; saved on the
    (2, 2) mesh, restored on a (1, 2) mesh and on one device: every
    leaf's whole value is the saved one, bit for bit (the parameters and
    the moments), placed per the restoring mesh."""
    i = runs["index"][("train", name)]
    steps = STEPS if TRAIN[name] == "trainer" else 1
    saved_one = _restored(runs["one"][i])
    saved_mesh = _restored(runs["four"][0][i])
    j = runs["index"][("restore", name)]
    for res in (r[j] for r in runs["four"]):
        assert res["info"]["step"] == steps
        got = _restored(res)
        assert set(got) == set(saved_one)
        for k, v in saved_one.items():
            assert torch.equal(got[k], v), k
        assert res["info"]["layout"] == _res(
            runs, "placements", name)[1][0]["info"]["want"]
    k = RESTORED.index(name)
    for res in [r[k] for r in runs["two"]] + [runs["back"][k]]:
        got = _restored(res)
        assert res["info"]["step"] == steps
        assert set(got) == set(saved_mesh)
        for key, v in saved_mesh.items():
            assert torch.equal(got[key], v), key


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_read_outside_rel(runs, fault):
    """On the (1, 2) mesh the sound prefill is within REL of one device,
    while each planted fault moves it outside: the checks above would
    catch a local chunk of the mLSTM's up-projection, and a per-rank RMS
    over Mamba2's split gated norm."""
    name = FAULTS[fault]
    k = len(RESTORED) + 2 * list(FAULTS).index(fault)
    one = _res(runs, "serve", name)[0]["tensors"]["logits"]
    for res in runs["two"]:
        sound, bad = res[k]["tensors"]["logits"], res[k + 1]["tensors"][
            "logits"]
        assert _rel(sound, one) <= REL
        assert _rel(bad, one) > REL
