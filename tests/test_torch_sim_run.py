"""Port parity: the ``repro_torch.launch.sim_run`` CLI against
``repro.launch.sim_run`` on the CPU (``--device cpu``).

The same flags give the same ``[sim]`` lines (the same fields and, where
they are counts or labels, the same values), a report file that loads with
the reference's reader, and, for what one card does not run yet, an exit
whose message names the ROADMAP item.
"""

import contextlib
import io
import json
import re

import pytest
import torch

from repro.launch import sim_run as jsim_run
from repro.obs import metrics as jmetrics
from repro.sim import ensemble as jens
from repro.sim import telemetry as jtelemetry
from repro_torch.launch import sim_run
from repro_torch.sim import ensemble as ens
from repro_torch.sim.telemetry import RunReport


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor operations: one thread per test worker, for the
    module's fixtures too (idle pool threads spin and starve the other
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    "single": ["--scenario", "plummer", "--n", "16", "--t-end", "0.02",
               "--dt", "0.00390625", "--diag-every", "4", "--no-validate"],
    "block_gather": ["--scenario", "plummer", "--n", "32", "--ensemble", "2",
                     "--t-end", "0.0625", "--stepper", "block", "--levels",
                     "3", "--compaction", "gather", "--block-i", "8",
                     "--block-j", "32", "--diag-every", "4",
                     "--no-validate"],
    "mixed": ["--scenario", "plummer:16", "two_body:2", "--pad", "auto",
              "--t-end", "0.02", "--dt", "0.00390625", "--diag-every", "4",
              "--no-validate"],
    # the strategies at one device, where the reference runs them in this
    # process
    "strategy_single": ["--scenario", "plummer", "--n", "16", "--t-end",
                        "0.02", "--dt", "0.00390625", "--strategy", "ring",
                        "--diag-every", "4", "--no-validate"],
    "strategy_block": ["--scenario", "binary_plummer", "--n", "24",
                       "--seed", "1", "--t-end", "0.0625", "--dt-max",
                       "0.015625", "--stepper", "block", "--levels", "4",
                       "--compaction", "gather", "--block-i", "8",
                       "--block-j", "128", "--strategy", "mesh_sharded",
                       "--impl", "xla", "--diag-every", "4",
                       "--no-validate"],
}


def _clear_engines():
    """Empty both packages' engine caches, so each run builds its engines
    and its ``[sim] metrics:`` line names the same ``engine.*`` counters
    whatever ran before in the process."""
    for fn in (jens._engine, jens._adaptive_engine, jens._block_engine,
               jens._strategy_block_engine, ens._engine,
               ens._adaptive_engine, ens._block_engine,
               ens._strategy_block_engine):
        fn.cache_clear()


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    out = {}
    root = tmp_path_factory.mktemp("cli")
    for name, argv in CASES.items():
        res = {}
        for tag, main, extra in (("ref", jsim_run.main, []),
                                 ("port", sim_run.main,
                                  ["--device", "cpu"])):
            path = str(root / f"{name}_{tag}.json")
            _clear_engines()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(argv + extra + ["--out", path]) == 0
            with open(path) as f:
                res[tag] = (buf.getvalue(), f.read(), path)
        out[name] = res
    return out


def _fields(line):
    """``key=value`` tokens of a ``[sim]`` line, in order."""
    return re.findall(r"([\w/|.]+)=(\S+)", line)


@pytest.mark.parametrize("name", CASES)
def test_sim_lines_match_the_references(cli_runs, name):
    ref_out, _, _ = cli_runs[name]["ref"]
    port_out, _, path = cli_runs[name]["port"]
    ref_lines = [ln for ln in ref_out.splitlines() if ln.startswith("[sim]")]
    port_lines = [ln for ln in port_out.splitlines()
                  if ln.startswith("[sim]")]
    assert len(ref_lines) == len(port_lines) >= 4
    assert ref_lines[0] == port_lines[0]     # scenario, stepper, dtype...
    for a, b in zip(ref_lines[1:], port_lines[1:]):
        fa, fb = _fields(a), _fields(b)
        assert [k for k, _ in fa] == [k for k, _ in fb], (a, b)
        for (k, va), (_, vb) in zip(fa, fb):
            if k in ("steps", "force_evals", "grid_tiles", "N_max",
                     "n_active", "t", "grid_tiles_per_shard"):
                assert va == vb, (k, a, b)
    metrics_line = [ln for ln in port_lines if "metrics:" in ln][0]
    assert "sim.events" in metrics_line
    assert port_lines[-1] == f"[sim] report -> {path}"


@pytest.mark.parametrize("name", CASES)
def test_report_file_loads_with_the_references_reader(cli_runs, name):
    _, ref_text, _ = cli_runs[name]["ref"]
    _, text, _ = cli_runs[name]["port"]
    report = jtelemetry.RunReport.from_json(text)
    jmetrics.validate_snapshot(report["metrics"])
    ours, theirs = RunReport.from_json(text), json.loads(ref_text)
    assert ours["steps"] == theirs["steps"]
    assert set(ours) == set(theirs)


def test_list_scenarios_equals_the_references(capsys):
    assert sim_run.main(["--list-scenarios"]) == 0
    ours = capsys.readouterr().out
    assert jsim_run.main(["--list-scenarios"]) == 0
    assert ours == capsys.readouterr().out


def test_trace_flag_writes_the_trace(tmp_path, capsys):
    trace_path = str(tmp_path / "cli_trace.json")
    out = _run(sim_run.main, CASES["block_gather"] + [
        "--device", "cpu", "--trace", trace_path, "--metrics-interval", "1",
        "--out", str(tmp_path / "r.json")], capsys)
    assert f"[sim] trace -> {trace_path}" in out
    names = {e["name"] for e in json.load(open(trace_path))["traceEvents"]}
    assert {"macro-step", "event", "kernel-launch"} <= names


@pytest.mark.parametrize("argv,item", [
    (["--ensemble", "2", "--devices", "2"], "item 7b"),
    (["--ensemble", "2", "--devices", "2", "--stepper", "block"], "item 7b"),
    (["--mesh", "1x1", "--stepper", "block"], "item 7b"),
    (["--sources", "neighbor", "--stepper", "block"], "item 8"),
])
def test_what_one_card_does_not_run_exits_naming_its_item(argv, item,
                                                          tmp_path):
    """Configurations the port once refused exit 0 and write their report:
    item 7b's (an ensemble over two CPU slots, the fused mesh) with the
    one-slot run's steps and energies, the neighbor scheme (item 8) with
    its neighbor fields."""
    base = ["--scenario", "plummer", "--n", "16", "--t-end", "0.01",
            "--no-validate", "--device", "cpu",
            "--out", str(tmp_path / "r.json")]
    if item == "item 8":
        assert sim_run.main(base + argv) == 0
        with open(tmp_path / "r.json") as f:
            report = json.load(f)
        assert report["sources"] == "neighbor"
        assert report["neighbor_refreshes"] > 0
        assert report["neighbor_overflows"] >= 0
        assert report["runs"][0]["neighbor_refreshes"] > 0
        return
    assert sim_run.main(base + argv) == 0
    with open(tmp_path / "r.json") as f:
        report = json.load(f)
    one_argv = [a for i, a in enumerate(argv)
                if a not in ("--devices", "--mesh")
                and (i == 0 or argv[i - 1] not in ("--devices", "--mesh"))]
    base[-1] = str(tmp_path / "one.json")
    assert sim_run.main(base + one_argv) == 0
    with open(tmp_path / "one.json") as f:
        one = json.load(f)
    assert report["devices"] == (2 if "--devices" in argv else 1)
    if "--mesh" in argv:
        assert report["mesh"] == [1, 1]
    for k in ("steps", "force_evals_total", "e0", "e1", "de_rel", "runs"):
        assert report[k] == one[k], k


@pytest.mark.parametrize("argv,line", [
    (["--devices", "2"], "strategy=single devices=2"),
    (["--strategy", "ring", "--devices", "4"], "strategy=ring devices=4"),
    (["--strategy", "mesh_sharded", "--stepper", "block", "--devices", "2",
      "--compaction", "gather", "--levels", "3", "--block-i", "8"],
     "strategy=mesh_sharded devices=2"),
])
def test_what_the_strategies_port_runs(argv, line, tmp_path, capsys):
    """Runs the reference's CLI shards over devices now run on the CPU's
    slots: a single run over several devices, a strategy run, a block run
    under a strategy with its per-shard tiles."""
    base = ["--scenario", "plummer", "--n", "16", "--t-end", "0.01",
            "--no-validate", "--device", "cpu",
            "--out", str(tmp_path / "r.json")]
    out = _run(sim_run.main, base + argv, capsys)
    assert line in out
    report = json.load(open(tmp_path / "r.json"))
    if "--stepper" in argv:
        assert len(report["grid_tiles_per_shard"]) == 2
        assert "[sim] grid_tiles_per_shard=" in out


def test_plain_version_flags_run_on_the_cpu(tmp_path, capsys):
    for flags in (["--kernel", "ref"], ["--impl", "xla"],
                  ["--kernel", "pallas"]):
        out = _run(sim_run.main, CASES["single"] + flags + [
            "--device", "cpu", "--out", str(tmp_path / "r.json")], capsys)
        assert "steps=6" in out
