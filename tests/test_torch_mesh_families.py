"""Port parity: the moe (MoE, and deepseek-v2's MLA with its leading
dense layer and shared experts), vlm (M-RoPE over patches and text) and
audio (encoder-decoder, cross-attention) families over a real device mesh,
four gloo ranks on the CPU as a (data=2, model=2) mesh, against the
reference on a (2, 2) ``jax.sharding.Mesh`` of four forced host devices
and against the port's single-device run of the same jobs
(``distributed.mesh_runs``).

One module-scoped spawn of four ranks runs every mesh job while one
subprocess runs the reference's meshed prefill and ``Engine`` and its
``Trainer`` (whose first step gives ``loss_fn``'s terms) on the same parameters (``params_from_jax``) and batches.
The configs are tiny: ``tests/test_torch_moe.py``'s MoE (8 experts, top
2) at two layers, and a variant with a shared expert and a leading dense
layer; an MLA config (latent ranks 32 and 48, rope dims 16) with both; a
vlm config with M-RoPE sections and 16 patches; an audio config with two
encoder and two decoder layers over 32 frames.  Held, each at ``REL``
(fp32, relative to the largest element):

* every parameter's placements and local shape equal ``MeshRules``'s, and
  ``param_specs`` on the real mesh equal the reference's, for the tiny
  configs and the four registered ones at full width;
* the meshed prefill logits against the single-device run's and the
  reference's meshed prefill, the greedy tokens of four decode steps
  equal on every rank, to the single-device run's and to the reference's;
  the flash route (its plain version on the CPU) as well for MoE, vlm and
  audio;
* the MoE aux loss against the reference's meshed ``loss_fn`` and one
  device: the means over the whole batch, not the mean of each rank's;
* MoE's dropped entries per sequence on each rank equal one device's on
  the same sequences, and two meshed prefills bit for bit;
* every gradient of one step against the single-device run's, placed as
  its parameter;
* two ``Trainer`` steps: losses against the reference's meshed
  ``Trainer`` and the single-device run, the final parameters within REL
  of each leaf's largest element but for Adam's flips (``FLIP_SHARE``),
  the moments placed as the parameters;
* the audio memory and the MLA latent cache placed by their logical axes.
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

from repro.models import params as JP
from repro.models.config import ArchConfig as JArchConfig
from repro_torch.distributed import mesh_runs, process_mesh
from repro_torch.models.config import ArchConfig

#: tests/test_torch_moe.py's BASE at two layers
MOE = dict(name="moe-small", family="moe", n_layers=2, d_model=64,
           n_heads=2, n_kv_heads=2, d_ff=128, moe_d_ff=96, vocab_size=256,
           n_experts=8, top_k=2, dtype="float32")
MOE_SHARED = dict(MOE, name="moe-shared", n_shared_experts=1,
                  first_k_dense=1)
#: deepseek-v2's layout in small: MLA, one leading dense layer, a shared
#: expert
MLA = dict(MOE_SHARED, name="mla-small", n_heads=4, n_kv_heads=4,
           kv_lora_rank=32, q_lora_rank=48, rope_head_dim=16, head_dim=16,
           v_head_dim=16)
VLM = dict(name="vlm-small", family="vlm", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
           mrope=True, mrope_sections=(2, 3, 3), frontend="vision_patches",
           frontend_len=16)
AUDIO = dict(name="audio-small", family="audio", n_layers=2,
             encoder_layers=2, is_encoder_decoder=True, d_model=64,
             n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
             dtype="float32", frontend="audio_frames")
FAMILIES = {"moe": MOE, "moe_shared": MOE_SHARED, "mla": MLA, "vlm": VLM,
            "audio": AUDIO}
#: the families served through the flash route too (MLA has none)
FLASH = ("moe", "vlm", "audio")
REGISTERED = ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "qwen2-vl-2b",
              "seamless-m4t-medium")
MESH = (2, 2)
B, S, GEN, MAX_LEN = 4, 16, 4, 40
N_PATCHES, N_FRAMES = 16, 32
STEPS, LR = 2, 1e-3
#: fp32, relative: the mesh sums its products, and MoE its experts'
#: contributions, in another order (measured <= 9e-7 on the logits, the
#: aux loss and the gradients)
REL = 1e-5
#: Adam's first steps divide m by sqrt(v): an element whose gradient lies
#: within fp32 noise of 0 takes a step of another size, up to lr apart
#: (tests/test_torch_train.py FLIP_SHARE)
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


def _family_inputs(name, cfg, seed):
    rng = np.random.default_rng(seed)
    extra = {}
    if cfg["family"] == "vlm":
        extra["patches"] = rng.standard_normal(
            (B, N_PATCHES, cfg["d_model"])).astype(np.float32)
    if cfg["family"] == "audio":
        extra["frames"] = rng.standard_normal(
            (B, N_FRAMES, cfg["d_model"])).astype(np.float32)
    tokens = rng.integers(0, cfg["vocab_size"], (B, S)).astype(np.int32)
    data = []
    for _ in range(STEPS):
        labels = rng.integers(0, cfg["vocab_size"], (B, S)).astype(np.int32)
        labels[rng.uniform(size=(B, S)) < 0.2] = -1      # masked out
        data.append(dict(extra, labels=labels, tokens=rng.integers(
            0, cfg["vocab_size"], (B, S)).astype(np.int32)))
    params = jax.tree.map(np.asarray, JP.init_params(
        JArchConfig(**cfg), jax.random.PRNGKey(seed)))
    return dict(cfg=cfg, params=params, tokens=tokens, extra=extra,
                data=data)


_JAX_MESH = textwrap.dedent(r"""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
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
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    rules = MeshRules.for_mesh(mesh)

    def specs(cfg):
        return jax.tree.map(
            tuple, P.param_specs(cfg, rules),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))

    out = {"specs": {n: specs(JC.get(n)) for n in inp["registered"]}}
    for key, fam in inp["families"].items():
        cfg = ArchConfig(**fam["cfg"])
        out["specs"][cfg.name] = specs(cfg)
        params = jax.tree.map(jax.device_put,
                              jax.tree.map(jnp.asarray, fam["params"]),
                              P.param_shardings(cfg, rules))
        batch = {k: jnp.asarray(v) for k, v in
                 dict(fam["extra"], tokens=fam["tokens"]).items()}
        # the engine's own jitted prefill: generate reuses its compilation
        eng = Engine(cfg, rules, params, ServeConfig(max_len=inp["max_len"]))
        logits, _ = eng._prefill(params, batch, max_len=inp["max_len"])
        toks, _ = eng.generate(batch, inp["gen"])
        data = fam["data"]
        opt = AdamW(learning_rate=inp["lr"])
        tr = Trainer(cfg, rules, opt, lambda step: data[step],
                     TrainerConfig(steps=len(data), log_every=10 ** 9),
                     log=lambda _m: None)
        p2, _, hist = tr.run(start_params=params, start_opt=opt.init(params))
        # the first step's loss terms are loss_fn's at the start parameters
        out[key] = {"logits": np.asarray(logits), "tokens": np.asarray(toks),
                    "terms": {k: float(hist[0][k])
                              for k in ("loss", "ce", "aux", "z")},
                    "train": {"loss": np.array([h["loss"] for h in hist]),
                              "params": jax.tree.map(np.asarray, p2)}}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _reference(tmp, inp):
    """The reference on a (2, 2) mesh of four forced host devices."""
    src = os.path.join(tmp, "ref_in.pkl")
    dst = os.path.join(tmp, "ref_out.pkl")
    with open(src, "wb") as f:
        pickle.dump(dict(families=inp, registered=REGISTERED, lr=LR,
                         max_len=MAX_LEN, gen=GEN), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    res = subprocess.run([sys.executable, "-c", _JAX_MESH, src, dst],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(dst, "rb") as f:
        return pickle.load(f)


def _jobs(inp):
    """Per family: placements, serve (xla; flash where the family has the
    route), grads and two Trainer steps."""
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
                     max_len=MAX_LEN, gen=GEN, repeat=1, **fam["extra"])
        add(("serve", name), serve)
        if name in FLASH:
            add(("serve_flash", name), dict(
                serve, cfg=dataclasses.replace(cfg, attn_impl="flash")))
        add(("grads", name), dict(common, kind="grads", data=fam["data"]))
        add(("train", name), dict(common, kind="train", steps=STEPS,
                                  data=fam["data"], moments=True,
                                  opt={"learning_rate": LR}))
    from repro_torch.models import config as C
    add(("specs", "registered"), dict(
        kind="placements", cfg=ArchConfig(**MOE), params=inp["moe"]["params"],
        spec_cfgs=[C.get(n) for n in REGISTERED]))
    return jobs, index


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's meshed run (a subprocess) while four ranks run the
    jobs on the (2, 2) mesh; the single-device run of the same jobs."""
    tmp = str(tmp_path_factory.mktemp("mesh_families"))
    inp = {name: _family_inputs(name, cfg, seed)
           for seed, (name, cfg) in enumerate(FAMILIES.items())}
    jobs, index = _jobs(inp)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_reference, tmp, inp)
        out = tempfile.mkdtemp(prefix="mesh_families_", dir=tmp)
        process_mesh.spawn(mesh_runs.lm_rank, 4, "gloo", "cpu",
                           [dict(j, mesh=MESH) for j in jobs], out)
        four = mesh_runs.load_ranks(out, 4)
        one = mesh_runs.in_process_lm("cpu", jobs)
        return dict(inp=inp, index=index, ref=ref.result(), one=one,
                    four=four)


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
    i = runs["index"][(kind, name)]
    return runs["one"][i], [r[i] for r in runs["four"]]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_placements_follow_the_rules(runs, name):
    """Every leaf's placements and local shape on every rank equal
    ``MeshRules.placements`` and ``local_shape`` of its logical axes."""
    _, four = _res(runs, "placements", name)
    for r, res in enumerate(four):
        assert res["info"]["layout"] == res["info"]["want"], r
    layout = four[0]["info"]["layout"]
    # (placements per mesh axis, data then model; the layers stacked first)
    if name == "moe":   # experts on "model", d_model on "data"
        assert layout["blocks/we_g"] == (("S(2)", "S(1)"), (2, 4, 32, 96))
        assert layout["blocks/router"] == (("S(1)", "R"), (2, 32, 8))
    if name == "mla":   # kv_b's flat heads axis on "model"
        assert layout["blocks/kv_b"] == (("R", "S(2)"), (1, 32, 64))
        assert layout["dense_blocks/q_b"] == (("R", "S(2)"), (1, 48, 64))


@pytest.mark.parametrize("name", [FAMILIES[n]["name"] for n in FAMILIES]
                         + list(REGISTERED))
def test_param_specs_equal_the_reference(runs, name):
    key = next((k for k, c in FAMILIES.items() if c["name"] == name), None)
    job = ("placements", key) if key else ("specs", "registered")
    got = _res(runs, *job)[1][0]["info"]["specs"][name]
    want = _flat(runs["ref"]["specs"][name], leaf=tuple)
    assert {k: tuple(v) for k, v in got.items()} == want


SERVE_CASES = ([("serve", n) for n in FAMILIES]
               + [("serve_flash", n) for n in FLASH])


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


@pytest.mark.parametrize("name", ["moe", "moe_shared", "mla"])
def test_moe_aux_loss_is_the_global_mean(runs, name):
    """The aux loss (and the CE and z terms) against the reference's
    meshed ``loss_fn`` (its Trainer's first step) and one device: ``me`` and ``ce`` are means over the
    whole batch before their product (the mean of each rank's
    ``e * sum(me * ce)`` is another number)."""
    one, four = _res(runs, "grads", name)
    ref = runs["ref"][name]["terms"]
    assert ref["aux"] > 0
    for r, res in enumerate(four):
        got = res["tensors"]
        for term in ("aux", "ce", "z"):
            assert _rel(got[f"term.{term}"], ref[term]) <= REL, (r, term)
            assert _rel(got[f"term.{term}"], one["tensors"][f"term.{term}"]
                        ) <= REL, (r, term)
        assert _rel(got["loss"], ref["loss"]) <= REL, r


@pytest.mark.parametrize("name", ["moe", "moe_shared", "mla"])
def test_moe_drops_per_sequence_as_one_device(runs, name):
    """Each rank routes its own sequences whole: the entries it drops over
    capacity, per MoE layer and sequence, are one device's for those
    sequences (the ranks of one "data" coordinate hold the same ones)."""
    one, four = _res(runs, "serve", name)
    want = one["info"]["dropped"]                # (moe layers, B)
    assert want.sum() > 0                        # the case drops entries
    half = B // MESH[0]
    for r, res in enumerate(four):
        d = res["info"]["coord"][0]
        got = res["info"]["dropped"]
        assert torch.equal(got, want[:, d * half:(d + 1) * half]), r


@pytest.mark.parametrize("name", list(FAMILIES))
def test_meshed_gradients_match_one_device(runs, name):
    """Every gradient on the mesh within REL of the one-device run's,
    placed as its parameter (a partial sum left unreduced, or a mean over
    ranks taken as a global one, shows here)."""
    one, four = _res(runs, "grads", name)
    layout = _res(runs, "placements", name)[1][0]["info"]["layout"]
    for r, res in enumerate(four):
        got = res["tensors"]
        assert _rel(got["loss"], one["tensors"]["loss"]) <= REL, r
        for key, want in one["tensors"].items():
            if key.startswith("grad."):
                assert _rel(got[key], want) <= REL, (r, key)
        assert res["info"]["layout"] == layout, r


def _assert_params_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        g = np.asarray(got[name], np.float64)
        w = np.asarray(w, np.float64)
        off = np.abs(g - w) > REL * np.abs(w).max()
        assert off.mean() <= FLIP_SHARE, (name, off.sum())
        assert np.abs(g - w).max() <= 4 * LR, name


@pytest.mark.parametrize("name", list(FAMILIES))
def test_two_trainer_steps_match_the_reference_and_one_device(runs, name):
    one, four = _res(runs, "train", name)
    ref = runs["ref"][name]["train"]
    ref_params = _flat(ref["params"])
    one_params = {k[len("params."):]: v for k, v in one["tensors"].items()
                  if k.startswith("params.")}
    for r, res in enumerate(four):
        t = res["tensors"]
        assert _rel(t["loss"], ref["loss"]) <= REL, r
        assert _rel(t["loss"], one["tensors"]["loss"]) <= REL, r
        got = {k[len("params."):]: v for k, v in t.items()
               if k.startswith("params.")}
        _assert_params_close(got, ref_params)
        _assert_params_close(got, one_params)
        # the moments are placed as their parameters
        assert res["info"]["opt_layout"] == res["info"]["layout"], r


def test_audio_memory_and_mla_latents_are_placed_by_their_axes(runs):
    """The audio memory on ("cache_batch", "cache_seq", "d_model"): split
    on "data", whole on "model"; MLA's latent c_kv and k_rope, which have
    no head axis, split on "data" and whole on "model", as is the dense
    layer's; the kv cache of the other layers on "data" and "model"."""
    audio = _res(runs, "serve", "audio")[1][0]["info"]["cache_leaves"]
    assert audio["memory"] == (("S(0)", "R"), (B // 2, N_FRAMES, 64))
    assert audio["layers/k"] == (("S(1)", "S(3)"), (2, B // 2, MAX_LEN, 2,
                                                     16))
    mla = _res(runs, "serve", "mla")[1][0]["info"]["cache_leaves"]
    for part in ("dense_layers", "layers"):
        assert mla[f"{part}/c_kv"] == (("S(1)", "R"), (1, B // 2, MAX_LEN,
                                                       32))
        assert mla[f"{part}/k_rope"] == (("S(1)", "R"), (1, B // 2, MAX_LEN,
                                                         16))
