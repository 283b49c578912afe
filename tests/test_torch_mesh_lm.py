"""Port parity: the dense LM over a real device mesh (``MeshRules`` on a
``DeviceMesh``, parameters and activations as ``DTensor``s), four gloo
ranks on the CPU as a (data=2, model=2) mesh, against the reference on a
(2, 2) ``jax.sharding.Mesh`` of four forced host devices and against the
port's single-device run of the same jobs (``distributed.mesh_runs``).

One module-scoped spawn of four ranks runs every mesh job while one
subprocess runs the reference's meshed prefill, ``Engine`` and
``Trainer`` on the same parameters (``params_from_jax``) and batches.
The config is ``tests/test_elastic.py``'s tiny dense one, plus variants
with one kv head (the kv heads stay whole while the q heads split; with
qk-norm and tied embeddings, as qwen3) and with the flash route.  Held:

* every parameter's placements and local shape equal ``MeshRules``'s, and
  ``param_specs`` on the real mesh equal the reference's, for the tiny
  config and for qwen3-0.6b at full width;
* the meshed prefill logits within ``REL`` (fp32) of the single-device
  run's and of the reference's meshed prefill; the greedy tokens of four
  decode steps equal on every rank, to the single-device run's and to the
  reference's;
* two ``Trainer`` steps: losses within ``REL`` of the reference's meshed
  ``Trainer`` and of the single-device run, and the final parameters
  within ``REL`` of each leaf's largest element, but for Adam's flips
  (``FLIP_SHARE``);
* every gradient of one step within ``REL`` of the single-device run's,
  placed as its parameter, for both configs;
* the flash wrapper on DTensors against the plain version on the whole;
* elastic restore, bit for bit: saved on one device, restored on the
  (2, 2) mesh; saved on the (2, 2) mesh, restored on a (1, 2) mesh of two
  ranks and on one device;
* the four collectives DTensor issues, with the all-gather staged
  through the host as CUDA ranks under gloo stage it;
* the ssm and hybrid families on a one-rank (1, 1) mesh: one device's
  bits.
"""

import concurrent.futures
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from repro.models import params as JP
from repro.models.config import ArchConfig as JArchConfig
from repro_torch.distributed import mesh_runs, process_mesh
from repro_torch.distributed.shardings import MeshRules
from repro_torch.kernels.flash_attention import _flash_plain
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import config as C
from repro_torch.models import layers, model
from repro_torch.models.config import ArchConfig
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_train_step
from repro_torch.optim import AdamW

#: tests/test_elastic.py's tiny dense config
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32")
#: one kv head on a model axis of two: the kv heads stay whole and each
#: rank's q heads read the one kv head; with qwen3's qk-norm and tied
#: embeddings
KV1 = dict(TINY, n_kv_heads=1, qk_norm=True, tie_embeddings=True)
MESH = (2, 2)
B, S, GEN, MAX_LEN = 4, 16, 4, 24
STEPS, LR = 2, 1e-3
#: fp32, relative: the mesh sums its products in another order (measured
#: <= 3e-7 on the logits and the losses)
REL = 1e-5
#: Adam's first steps divide m by sqrt(v): an element whose gradient lies
#: within fp32 noise of 0 takes a step of another size, up to lr apart
#: (tests/test_torch_train.py FLIP_SHARE).  Up to this share of a leaf's
#: elements may leave the REL bound, each within 2 * 2 * LR
FLIP_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor operations: one thread per test worker, for the
    module's fixtures too (idle pool threads spin and starve the other
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(cfg, seed):
    return jax.tree.map(np.asarray, JP.init_params(JArchConfig(**cfg),
                                                   jax.random.PRNGKey(seed)))


def _inputs():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)
    data = []
    for _ in range(STEPS):
        labels = rng.integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)
        labels[rng.uniform(size=(B, S)) < 0.2] = -1      # masked out
        data.append({"tokens": rng.integers(0, TINY["vocab_size"], (B, S))
                     .astype(np.int32), "labels": labels})
    qkv = {n: rng.standard_normal((B, S, h, 16)).astype(np.float32)
           for n, h in (("q", 4), ("k", 2), ("v", 2))}
    return dict(params=_jax_params(TINY, 7), params_kv1=_jax_params(KV1, 8),
                tokens=tokens, data=data, qkv=qkv)


_JAX_MESH = textwrap.dedent(r"""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import functools
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.models import config as JC
    from repro.distributed.shardings import MeshRules
    from repro.models import model, params as P
    from repro.models.config import ArchConfig
    from repro.optim import AdamW
    from repro.serve.engine import Engine, ServeConfig
    from repro.train import Trainer, TrainerConfig

    inp = pickle.load(open(sys.argv[1], "rb"))
    tiny = ArchConfig(**inp["tiny"])
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    rules = MeshRules.for_mesh(mesh)
    out = {"specs": {c.name: jax.tree.map(
        tuple, P.param_specs(c, rules),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for c in (tiny, JC.get("qwen3-0.6b"))}}

    def placed(cfg, tree):
        return jax.tree.map(jax.device_put, jax.tree.map(jnp.asarray, tree),
                            P.param_shardings(cfg, rules))

    batch = {"tokens": jnp.asarray(inp["tokens"])}
    for key, cfg in (("tiny", tiny), ("kv1", ArchConfig(**inp["kv1"]))):
        params = placed(cfg, inp["params" if key == "tiny" else "params_kv1"])
        logits, _ = jax.jit(functools.partial(model.prefill, cfg, rules),
                            static_argnames=("max_len",))(
            params, batch, max_len=inp["max_len"])
        toks, _ = Engine(cfg, rules, params,
                         ServeConfig(max_len=inp["max_len"])).generate(
            batch, inp["gen"])
        out[key] = {"logits": np.asarray(logits), "tokens": np.asarray(toks)}

    params = placed(tiny, inp["params"])
    opt = AdamW(learning_rate=inp["lr"])
    tr = Trainer(tiny, rules, opt, lambda step: inp["data"][step],
                 TrainerConfig(steps=len(inp["data"]), log_every=10 ** 9),
                 log=lambda _m: None)
    params, _, hist = tr.run(start_params=params, start_opt=opt.init(params))
    out["train"] = {"loss": np.array([h["loss"] for h in hist]),
                    "params": jax.tree.map(np.asarray, params)}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _reference(tmp, inp):
    """The reference on a (2, 2) mesh of four forced host devices."""
    src = os.path.join(tmp, "ref_in.pkl")
    dst = os.path.join(tmp, "ref_out.pkl")
    with open(src, "wb") as f:
        pickle.dump(dict(tiny=TINY, kv1=KV1, params=inp["params"],
                         params_kv1=inp["params_kv1"], tokens=inp["tokens"],
                         data=inp["data"], lr=LR, max_len=MAX_LEN, gen=GEN),
                    f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    res = subprocess.run([sys.executable, "-c", _JAX_MESH, src, dst],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(dst, "rb") as f:
        return pickle.load(f)


def _cfg(d, **kw):
    return dataclasses.replace(ArchConfig(**d), **kw)


def _jobs(inp, ckpt_dir):
    serve = dict(kind="serve", tokens=inp["tokens"], max_len=MAX_LEN, gen=GEN)
    opt = {"learning_rate": LR}
    return [
        dict(kind="placements", cfg=_cfg(TINY), params=inp["params"],
             spec_cfgs=[_cfg(TINY), C.get("qwen3-0.6b")]),
        dict(serve, cfg=_cfg(TINY), params=inp["params"]),
        dict(serve, cfg=_cfg(KV1), params=inp["params_kv1"]),
        dict(serve, cfg=_cfg(TINY, attn_impl="flash"), params=inp["params"]),
        dict(kind="train", cfg=_cfg(TINY), params=inp["params"], steps=STEPS,
             data=inp["data"], opt=opt, ckpt_dir=ckpt_dir),
        dict(kind="flash", causal=True, block=8, cfg=_cfg(TINY),
             **inp["qkv"]),
        dict(kind="grads", cfg=_cfg(TINY), params=inp["params"],
             data=inp["data"]),
        dict(kind="grads", cfg=_cfg(KV1), params=inp["params_kv1"],
             data=inp["data"]),
    ]


JOB = {"placements": 0, "serve": 1, "serve_kv1": 2, "serve_flash": 3,
       "train": 4, "flash": 5, "grads": 6, "grads_kv1": 7}


def _spawn(world, jobs):
    out = tempfile.mkdtemp(prefix="mesh_lm_")
    process_mesh.spawn(mesh_runs.lm_rank, world, "gloo", "cpu", jobs, out)
    return mesh_runs.load_ranks(out, world)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's meshed run (a subprocess), four ranks on the (2, 2)
    mesh and the single-device run of the same jobs, then the restores."""
    tmp = str(tmp_path_factory.mktemp("mesh_lm"))
    inp = _inputs()
    one_dir, mesh_dir = os.path.join(tmp, "one"), os.path.join(tmp, "mesh")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_reference, tmp, inp)
        # the single-device run first: the mesh restores its checkpoint
        one = mesh_runs.in_process_lm("cpu", _jobs(inp, one_dir))
        restore = dict(kind="restore", cfg=_cfg(TINY), opt={"learning_rate": LR})
        # last, the collective probe with the all-gather staged through
        # the host as CUDA ranks under gloo stage it (here on "CPU")
        four = _spawn(4, [dict(j, mesh=MESH) for j in _jobs(inp, mesh_dir)]
                      + [dict(restore, mesh=MESH, ckpt_dir=one_dir),
                         dict(kind="probe", mesh=MESH, stage="CPU")])
        two = _spawn(2, [dict(restore, mesh=(1, 2), ckpt_dir=mesh_dir)])
        back = mesh_runs.in_process_lm("cpu", [dict(restore,
                                                     ckpt_dir=mesh_dir)])
        return dict(inp=inp, ref=ref.result(), one=one, four=four, two=two,
                    back=back[0])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _flat_np(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(_flat_np(tree[k], path))
        else:
            out[path] = np.asarray(tree[k])
    return out


def test_placements_follow_the_rules(runs):
    """Every leaf's placements and local shape on every rank equal
    ``MeshRules.placements`` and ``local_shape`` of its logical axes."""
    for r, res in enumerate(runs["four"]):
        info = res[JOB["placements"]]["info"]
        assert info["layout"] == info["want"], r
    # the (2, 2) mesh splits the tiny config's leaves both ways
    q = runs["four"][0][JOB["placements"]]["info"]["layout"]["blocks/q"]
    assert q[1] == (2, 32, 32)


@pytest.mark.parametrize("name", ["tiny", "qwen3-0.6b"])
def test_param_specs_equal_the_reference(runs, name):
    got = runs["four"][0][JOB["placements"]]["info"]["specs"][name]
    want = {}

    def walk(tree, prefix=""):
        for k in sorted(tree):
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(tree[k], dict):
                walk(tree[k], path)
            else:
                want[path] = tuple(tree[k])
    walk(runs["ref"]["specs"][name])
    assert {k: tuple(v) for k, v in got.items()} == want


@pytest.mark.parametrize("job,ref_key", [("serve", "tiny"),
                                         ("serve_kv1", "kv1"),
                                         ("serve_flash", "tiny")])
def test_meshed_prefill_and_greedy_tokens(runs, job, ref_key):
    """Prefill logits within REL of the single-device run and of the
    reference's meshed prefill; the greedy tokens equal everywhere."""
    i = JOB[job]
    one = runs["one"][i]["tensors"]
    ref = runs["ref"][ref_key]
    for r, res in enumerate(runs["four"]):
        got = res[i]["tensors"]
        assert _rel(got["logits"], one["logits"]) <= REL, r
        assert _rel(got["logits"], ref["logits"]) <= REL, r
        assert torch.equal(got["tokens"], one["tokens"]), r
        np.testing.assert_array_equal(got["tokens"].numpy(), ref["tokens"])


def test_meshed_cache_is_placed_by_its_logical_axes(runs):
    """The decode cache splits on cache_batch (data) and, where they
    split, on the kv heads (model); one kv head stays whole."""
    two = runs["four"][0][JOB["serve"]]["info"]["cache_layout"]["k"]
    one = runs["four"][0][JOB["serve_kv1"]]["info"]["cache_layout"]["k"]
    assert two[1] == (2, B // 2, MAX_LEN, 1, 16)
    assert one[1] == (2, B // 2, MAX_LEN, 1, 16)
    assert two[0] != one[0]


def _assert_params_close(got: dict, want: dict):
    for name, w in want.items():
        g = np.asarray(got[name], np.float64)
        w = np.asarray(w, np.float64)
        off = np.abs(g - w) > REL * np.abs(w).max()
        assert off.mean() <= FLIP_SHARE, (name, off.sum())
        assert np.abs(g - w).max() <= 4 * LR, name


def test_two_trainer_steps_match_the_reference_and_one_device(runs):
    i = JOB["train"]
    ref = runs["ref"]["train"]
    ref_params = _flat_np(ref["params"])
    one = runs["one"][i]["tensors"]
    for r, res in enumerate(runs["four"]):
        t = res[i]["tensors"]
        assert _rel(t["loss"], ref["loss"]) <= REL, r
        assert _rel(t["loss"], one["loss"]) <= REL, r
        got = {k[len("params."):]: v for k, v in t.items()
               if k.startswith("params.")}
        _assert_params_close(got, ref_params)
        _assert_params_close(got, {k[len("params."):]: v for k, v in
                                   one.items() if k.startswith("params.")})
        # the moments are placed as their parameters
        info = res[i]["info"]
        assert info["opt_layout"] == info["layout"], r


@pytest.mark.parametrize("job", ["grads", "grads_kv1"])
def test_meshed_gradients_match_one_device(runs, job):
    """Every gradient on the mesh within REL of the one-device run's, placed
    as its parameter (Adam's update is blind to a gradient's scale, so the
    gradients themselves are held: a partial sum left unreduced shows
    here)."""
    i = JOB[job]
    one = runs["one"][i]["tensors"]
    layout = runs["four"][0][JOB["placements"]]["info"]["layout"]
    for r, res in enumerate(runs["four"]):
        got = res[i]["tensors"]
        assert _rel(got["loss"], one["loss"]) <= REL, r
        for name, want in one.items():
            if name.startswith("grad."):
                assert _rel(got[name], want) <= REL, (r, name)
        if job == "grads":
            assert res[i]["info"]["layout"] == layout, r


def test_flash_wrapper_on_dtensors(runs):
    """The flash wrapper on q split on B and H, k and v on B and KV: each
    rank's local block through the plain version, the whole equal to the
    plain version on the whole; ``_attn_dispatch`` under the rules runs
    ``_attn_full`` on the local heads."""
    qkv = {n: torch.from_numpy(x) for n, x in runs["inp"]["qkv"].items()}
    want = _flash_plain(qkv["q"], qkv["k"], qkv["v"], causal=True,
                        block_q=8, block_k=8)
    xla = layers._attn_full(qkv["q"], qkv["k"], qkv["v"], causal=True)
    for res in runs["four"]:
        r = res[JOB["flash"]]
        assert torch.equal(r["tensors"]["out"], want)
        assert r["info"]["placements"] == (str(Shard(0)), str(Shard(2)))
        # _attn_dispatch on DTensors: the xla route on local heads
        assert _rel(r["tensors"]["dispatch"], xla) <= REL


def _restored(res):
    return {k: v for k, v in res["tensors"].items()
            if k.startswith(("params.", "m."))}


def test_elastic_restore_bit_for_bit(runs):
    """Saved on one device, restored on the (2, 2) mesh; saved on the (2,
    2) mesh, restored on a (1, 2) mesh and on one device: every leaf's
    whole value is the saved one, bit for bit, placed per the restoring
    mesh."""
    one_train = runs["one"][JOB["train"]]["tensors"]
    mesh_train = runs["four"][0][JOB["train"]]["tensors"]
    saved_one = {k: v for k, v in one_train.items() if k.startswith("params.")}
    saved_mesh = {k: v for k, v in mesh_train.items()
                  if k.startswith("params.")}
    restored4 = [res[len(JOB)] for res in runs["four"]]
    for res in restored4:
        got = _restored(res)
        assert res["info"]["step"] == STEPS
        for k, v in saved_one.items():
            assert torch.equal(got[k], v), k
        assert res["info"]["layout"]["blocks/q"][1] == (2, 32, 32)
    for res in [r[0] for r in runs["two"]] + [runs["back"]]:
        got = _restored(res)
        for k, v in saved_mesh.items():
            assert torch.equal(got[k], v), k
        # the moments restored too, equal across restoring meshes
        for k, v in _restored(runs["back"]).items():
            assert torch.equal(got[k], v), k
    assert runs["two"][0][0]["info"]["layout"]["blocks/q"][1] == (2, 64, 32)
    assert runs["back"]["info"]["layout"]["blocks/q"] == ((), (2, 64, 64))


def test_collectives_with_the_staged_all_gather(runs):
    """The four collectives DTensor issues, each checked on every rank,
    with the functional all-gather routed through the host
    (``process_mesh.stage_functional_all_gather``)."""
    for r, res in enumerate(runs["four"]):
        info = res[len(JOB) + 1]["info"]
        # the checks' all-gathers, and the CPU's all-to-all, which gloo
        # runs as an all-gather: five staged
        assert info == {"all_gather": True, "reduce_scatter": True,
                        "all_reduce": True, "all_to_all": True,
                        "staged_gathers": 5}, r


@pytest.fixture
def one_rank_mesh():
    """A real (1, 1) mesh in this process: a one-rank gloo group."""
    with process_mesh.single_rank_group("gloo", "cpu"):
        yield MeshRules.for_mesh(make_device_mesh((1, 1), ("data", "model"),
                                                  "cpu"))


def _bits(tree) -> dict:
    """Every tensor leaf whole on the host, flat."""
    return {k: mesh_runs.full(v).detach().cpu()
            for k, v in mesh_runs._flat(tree).items()
            if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("arch", ["ssm", "hybrid"])
def test_ssm_and_hybrid_on_a_one_rank_mesh_give_one_device_bits(
        one_rank_mesh, arch):
    """The ssm and hybrid families on a real (1, 1) mesh, every leaf a
    DTensor, give one device's bits: the prefill logits and cache, the
    greedy tokens of ``Engine.generate``, and an accumulated int8 train
    step's parameters, moments and error buffers (tests/test_torch_mesh_
    ssm.py holds them on (2, 2) against the reference's mesh)."""
    from repro_torch.distributed.compression import zeros_error
    from repro_torch.models import params as P
    from repro_torch.serve.engine import ServeConfig
    cfg = _cfg(TINY, family=arch, slstm_every=2, attn_every=2, ssm_state=16,
               chunk_size=8)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, 256, (B, S)))
    batch = {"tokens": torch.from_numpy(rng.integers(0, 256, (B, S))),
             "labels": torch.from_numpy(rng.integers(-1, 256, (B, S)))}
    runs = []
    for rules in (model.SINGLE, one_rank_mesh):
        params = P.init_params(cfg, torch.Generator().manual_seed(3),
                               device="cpu", rules=rules)
        logits, cache = model.prefill(cfg, params, {"tokens": tokens},
                                      max_len=MAX_LEN, rules=rules)
        toks, _ = Engine(cfg, params, ServeConfig(max_len=MAX_LEN),
                         rules=rules).generate({"tokens": tokens}, GEN)
        opt = AdamW(learning_rate=LR)
        step = make_train_step(cfg, opt, rules=rules, accum=2,
                               grad_compression="int8")
        params, state, met, err = step(params, opt.init(params), batch,
                                       zeros_error(params))
        runs.append(dict(logits=mesh_runs.full(logits), toks=toks,
                         loss=met["loss"], cache=_bits(cache),
                         params=_bits(params), m=_bits(state.m),
                         err=_bits(err)))
    one, mesh = runs
    assert torch.equal(mesh["logits"], one["logits"])
    assert torch.equal(mesh["toks"], one["toks"])
    assert torch.equal(mesh["loss"], one["loss"])
    for key in ("cache", "params", "m", "err"):
        assert mesh[key].keys() == one[key].keys(), key
        for leaf, v in one[key].items():
            assert torch.equal(mesh[key][leaf], v), (key, leaf)
