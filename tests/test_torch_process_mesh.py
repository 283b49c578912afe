"""Port parity: the strategies over a mesh of processes
(``repro_torch.distributed.process_mesh``), one gloo rank per shard on the
CPU, against the in-process ``DeviceMesh`` and the JAX package.

One module-scoped spawn of four ranks runs every strategy (the ring in
both schedules, two_level as two cards of two chips) at Plummer N = 500
and 501 (501 pads the shards), fp32 and mixed: a bootstrap and two fixed
steps through ``hermite``, and one block evaluation per compaction with an
uneven activity mask; then ``compressed_psum``.  A spawn of two ranks runs
two_level as one card of two chips.  Held:

* every rank's output equal, bit for bit, to the in-process mesh's over
  the same number of CPU slots (the same code: ``distributed.mesh_runs``),
  with equal shift counts and per-shard tiles;
* the bootstrap against the JAX ``make_evaluator(impl="xla")`` within
  ``REL``, 1e-5 relative per field, as ``tests/test_torch_strategies.py``
  holds the in-process strategies (the sum over sources runs in another
  order);
* the ring's overlap == sync and each block evaluator's gather == none,
  bit for bit;
* ``compressed_psum`` on four ranks equal, bit for bit, to the
  reference's under ``jax.vmap(..., axis_name="i")``.
"""

import concurrent.futures
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.evaluate import make_evaluator as jmake_evaluator
from repro.distributed.compression import compressed_psum as jcompressed_psum
from repro_torch.core import hermite, nbody, strategies
from repro_torch.core.evaluate import make_evaluator
from repro_torch.distributed import mesh_runs, process_mesh
from repro_torch.launch import nbody_run

#: tests/test_torch_strategies.py REL
REL = 1e-5
NS = (500, 501)
DTYPES = ("fp32", "mixed")
#: (strategy, ring mode): every strategy, the ring in both schedules
MODES = [(s, "overlap") for s in strategies.STRATEGIES] + [("ring", "sync")]
STEPS = 2
#: block evaluations: tiles small enough that a shard of 125 rows has
#: several capacity buckets
BLOCK_TILES = dict(block_i=16, block_j=32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor operations: one thread per test worker, for the
    module's fixtures too (idle pool threads spin and starve the other
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block_inputs(n, seed=2, frac=0.4):
    """An initialized Plummer state's (pos, vel, acc_pred, mass, mask): a
    random mask, the first half of the rows twice as active, and a
    perturbed predicted acceleration."""
    state = hermite.initialize(nbody.plummer(n, seed=seed, device="cpu"),
                               make_evaluator())
    rng = np.random.default_rng(seed)
    p_act = np.where(np.arange(n) < n // 2, 2 * frac, frac / 2)
    mask = torch.tensor(rng.uniform(size=n) < p_act)
    ap = state.acc + 0.01 * torch.tensor(rng.standard_normal((n, 3)))
    return state.pos, state.vel, ap, state.mass, mask


def _job_id(job):
    return "-".join(str(job[k]) for k in
                    ("kind", "strategy", "ring_mode", "compaction", "n",
                     "dtype", "chips_per_card") if k in job)


def _jobs(modes, chips_per_card=2):
    jobs = []
    for n in NS:
        inputs = _block_inputs(n)
        for dtype in DTYPES:
            for strategy, mode in modes:
                kw = dict(strategy=strategy, ring_mode=mode, n=n,
                          dtype=dtype, chips_per_card=chips_per_card)
                jobs.append(dict(kind="lockstep", seed=7, steps=STEPS,
                                 **kw))
                for compaction in strategies.COMPACTIONS:
                    jobs.append(dict(kind="block", compaction=compaction,
                                     inputs=inputs, **BLOCK_TILES, **kw))
    return jobs


JOBS4 = _jobs(MODES)
#: two_level at one card of two chips
JOBS2 = _jobs([("two_level", "overlap")])
PSUM_X = np.random.default_rng(0).standard_normal((4, 257)).astype(
    np.float32)


def _spawn(tmp_path_factory, world, jobs):
    out = str(tmp_path_factory.mktemp(f"ranks{world}"))
    process_mesh.spawn(mesh_runs.strategy_rank, world, "gloo", "cpu", jobs,
                       out)
    return mesh_runs.load_ranks(out, world)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every job of ``JOBS4`` and ``compressed_psum`` on four gloo ranks,
    and the same jobs on the in-process mesh of four CPU slots."""
    psum = dict(kind="psum", x=torch.tensor(PSUM_X))
    return _beside(tmp_path_factory, 4, JOBS4 + [psum], JOBS4)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _beside(tmp_path_factory, 2, JOBS2, JOBS2)


def _beside(tmp_path_factory, world, jobs, local_jobs):
    """The ranks' results and the in-process mesh's, the second computed
    here while the ranks run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_spawn, tmp_path_factory, world, jobs)
        ref = mesh_runs.in_process(["cpu"] * world, local_jobs)
        return ranks.result(), ref


def _index(jobs, **kw):
    (i,) = [i for i, j in enumerate(jobs)
            if all(j.get(k) == v for k, v in kw.items())]
    return i


def _assert_ranks_equal_in_process(ranks, ref, i):
    want = ref[i]
    for r, res in enumerate(ranks):
        got = res[i]
        assert got["tensors"].keys() == want["tensors"].keys()
        for name, t in want["tensors"].items():
            assert torch.equal(got["tensors"][name], t), (r, name)
            assert got["digests"][name] == mesh_runs.digest(t), (r, name)
        # a rank launches its one slot's share of the mesh's launches
        # (none on the CPU) and issues every shift round
        c, w = got["counts"], want["counts"]
        assert c["shifts"] == w["shifts"], r
        for k in ("acc_jerk_pot", "snap"):
            assert len(ranks) * c[k] == w[k], (r, k)


@pytest.mark.parametrize("i", range(len(JOBS4)),
                         ids=[_job_id(j) for j in JOBS4])
def test_every_rank_gives_the_in_process_bits(four_ranks, i):
    """Each of four ranks returns the whole output, equal bit for bit to
    the in-process mesh's: the bootstrap and the state after two steps,
    or the block evaluation and its per-shard tiles; shift counts equal."""
    ranks, ref = four_ranks
    _assert_ranks_equal_in_process(ranks, ref, i)


@pytest.mark.parametrize("i", range(len(JOBS2)),
                         ids=[_job_id(j) for j in JOBS2])
def test_two_level_on_one_card_of_two_chips(two_ranks, i):
    """two_level over two ranks, a ``(1, 2)`` (card, chip) grid: the
    sub-groups of one card and of each chip index, in-process bits."""
    ranks, ref = two_ranks
    _assert_ranks_equal_in_process(ranks, ref, i)


@pytest.fixture(scope="module")
def jax_single():
    """The JAX single-device evaluation of each Plummer state, by (n,
    dtype)."""
    out = {}
    for n in NS:
        s = nbody.plummer(n, seed=7, device="cpu")
        args = [jnp.asarray(x.numpy()) for x in (s.pos, s.vel, s.mass)]
        for dtype in DTYPES:
            out[(n, dtype)] = jmake_evaluator(impl="xla", dtype=dtype)(*args)
    return out


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max()
                 / (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("strategy,mode", MODES)
def test_bootstrap_agrees_with_the_jax_single_path(four_ranks, jax_single,
                                                   strategy, mode, n,
                                                   dtype):
    ranks, _ = four_ranks
    i = _index(JOBS4, kind="lockstep", strategy=strategy, ring_mode=mode,
               n=n, dtype=dtype)
    got = ranks[0][i]["tensors"]
    for f in mesh_runs.EVAL_FIELDS:
        want = getattr(jax_single[(n, dtype)], f)
        assert tuple(got[f"boot.{f}"].shape) == want.shape
        assert _rel(got[f"boot.{f}"], want) < REL, f


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_ring_overlap_equals_sync_over_ranks(four_ranks, n, dtype):
    """Bit for bit on every rank; the overlap schedule issues 2 (p - 1)
    shift rounds per evaluation on each rank, sync 2 p (a bootstrap and
    two steps are three evaluations)."""
    ranks, _ = four_ranks
    ov, sy = (_index(JOBS4, kind="lockstep", strategy="ring", ring_mode=m,
                     n=n, dtype=dtype) for m in ("overlap", "sync"))
    for res in ranks:
        for name, t in res[ov]["tensors"].items():
            assert torch.equal(t, res[sy]["tensors"][name]), name
        evals = STEPS + 1
        assert res[ov]["counts"]["shifts"] == evals * 2 * 3
        assert res[sy]["counts"]["shifts"] == evals * 2 * 4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("strategy,mode", MODES)
def test_block_gather_equals_none_over_ranks(four_ranks, strategy, mode, n,
                                             dtype):
    """gather == none bit for bit on every rank, with no more tiles on any
    shard; the tiles are a (4,) vector on every rank."""
    ranks, _ = four_ranks
    none, gather = (_index(JOBS4, kind="block", strategy=strategy,
                           ring_mode=mode, n=n, dtype=dtype, compaction=c)
                    for c in strategies.COMPACTIONS)
    for res in ranks:
        a, b = res[none]["tensors"], res[gather]["tensors"]
        for f in mesh_runs.EVAL_FIELDS:
            assert torch.equal(a[f"eval.{f}"], b[f"eval.{f}"]), f
        assert tuple(b["tiles"].shape) == (4,)
        assert (b["tiles"] <= a["tiles"]).all()
        assert (b["tiles"] < a["tiles"]).any()


def test_compressed_psum_equals_the_reference_under_vmap(four_ranks):
    """Each rank's ``compressed_psum`` of its row is the reference's, run
    under ``jax.vmap`` with the ranks as the named axis, bit for bit."""
    ranks, _ = four_ranks
    want = np.asarray(jax.vmap(lambda v: jcompressed_psum(v, "i"),
                               axis_name="i")(jnp.asarray(PSUM_X)))
    for r, res in enumerate(ranks):
        got = res[-1]["tensors"]["sum"]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want[r])


def test_nccl_refuses_more_ranks_than_visible_cards():
    """The caller names the backend; nccl with more ranks than cards
    raises before any process or group exists, naming the visible
    count."""
    visible = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"{visible} cards visible"):
        process_mesh.spawn(mesh_runs.strategy_rank, visible + 1, "nccl",
                           "cuda", [], "unused")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="nccl sends CUDA tensors"):
        process_mesh.check_backend("nccl", 1, "cpu")
    with pytest.raises(ValueError, match="backend must be one of"):
        process_mesh.check_backend("mpi", 1, "cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        process_mesh.ProcessMesh("gloo", device="cpu")


def test_a_mesh_or_devices_not_both():
    mesh = strategies.DeviceMesh(["cpu"] * 2)
    assert mesh.local([3, 4]) == [3, 4]
    grid = strategies.make_mesh("two_level", mesh)
    assert isinstance(grid, strategies.DeviceMesh)
    assert (grid.shape, grid.axis_names) == ((1, 2), ("card", "chip"))
    with pytest.raises(ValueError, match="not both"):
        strategies.make_strategy_evaluator("ring", devices=["cpu"] * 2,
                                           mesh=mesh)


def _nbody_lines(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("[nbody]")]
    assert len(lines) == 2, out
    return lines[0], re.sub(r"wall=\S+ ", "", lines[1])


def test_nbody_run_over_gloo_prints_the_in_process_line(capfd):
    """``--backend gloo --devices 4`` runs four processes; rank 0 prints
    the in-process run's ``[nbody]`` lines (the wall clock aside) and the
    transport."""
    argv = ["--n", "64", "--t-end", "0.0078125", "--dt", "0.00390625",
            "--strategy", "ring", "--devices", "4", "--device", "cpu"]
    assert nbody_run.main(argv) == 0
    want = _nbody_lines(capfd.readouterr().out)
    assert nbody_run.main(argv + ["--backend", "gloo"]) == 0
    out = capfd.readouterr().out
    assert "transport: gloo, host memory" in out
    assert _nbody_lines(out) == want
    assert "devices=4 device=cpu" in want[0]
