"""Scenario/ensemble simulation launcher: ``repro_torch.sim``'s front door.

Port of ``repro/launch/sim_run.py``: the same flags and ``[sim]`` lines,
and a JSON report in the reference's schema.

    PYTHONPATH=src python -m repro_torch.launch.sim_run \
        --scenario plummer --n 16384 --t-end 0.0625 --dtype fp32
    PYTHONPATH=src python -m repro_torch.launch.sim_run \
        --scenario binary_plummer --n 16384 --stepper block --levels 10 \
        --compaction gather --t-end 0.0625
    PYTHONPATH=src python -m repro_torch.launch.sim_run \
        --scenario king:256 merger:512 plummer:128 --pad auto --device cpu

``--device {cuda,cpu}`` (default ``cuda``, which refuses to start without a
card) picks the hand-written kernels or their plain versions.

``--strategy {replicated,two_level,mesh_sharded,ring}`` shards one run's
domain over ``--devices k`` shards (``core.strategies``): on ``cpu`` k
slots on the CPU, on ``cuda`` the first k cards, refused with the visible
count when fewer are there:

    PYTHONPATH=src python -m repro_torch.launch.sim_run --device cpu \
        --devices 4 --strategy ring --scenario plummer --n 256 --t-end 0.0625
    PYTHONPATH=src python -m repro_torch.launch.sim_run --strategy \
        mesh_sharded --stepper block --compaction gather --devices 1 \
        --scenario binary_plummer --n 16384 --levels 10 --t-end 0.0625

``--scenario`` takes either one registry name (homogeneous runs; ``name:N``
is shorthand for ``--n N``) or several ``name:N`` tokens — a *mixed*
ensemble, packed into one rectangular batch with zero-mass padding up to
``--pad`` (``auto`` = largest member).  ``--kernel pallas`` (or no
``--kernel``) runs the device's own path; ``--kernel ref``, ``--impl xla``
and ``--impl pallas_interpret`` name plain versions and run on ``cpu``
only.  Mixed-run telemetry counts interactions with each run's
``n_active``, never the padded N.

``--stepper {fixed,adaptive,block}`` selects the timestep mode:
``fixed`` (``--dt``), ``adaptive`` (shared Aarseth lockstep, capped at
``--dt-max``), or ``block`` (hierarchical per-particle power-of-two levels,
``--dt-max`` x ``--levels``; ``--levels auto`` sizes the hierarchy from the
initial Aarseth dt distribution).  Telemetry reports the *measured* per-run
force-evaluation counts in every mode.  ``--compaction gather``
additionally gathers each event's active targets into a dense
block-aligned buffer so the kernel grid *shrinks* to the live block
instead of masking it (``--block-i/--block-j`` set the logical tile);
``--bucket-mode member`` (the default) dispatches a mixed batch's capacity
buckets per member group instead of batch-shared.  ``--sources neighbor``
runs the block stepper's Ahmad-Cohen split (near force over gathered
per-block windows of ``--neighbor-radius``, far field refreshed every
``n_sub >> --refresh-levels`` ticks); the rows are sorted spatially once
at build:

    PYTHONPATH=src python -m repro_torch.launch.sim_run --scenario \
        plummer --n 16384 --stepper block --sources neighbor \
        --block-i 32 --block-j 32 --neighbor-radius 0.125 --t-end 0.0625

An ensemble over ``--devices k`` (k > 1) shards its members over k slots,
and ``--mesh BxP`` (``B * P`` equal to ``--devices``) runs the block
stepper on the fused ``(batch, dev)`` grid: B batch shards, each member's
domain split P ways.  A strategy label on a batched run only tags the
report, as in the reference:

    PYTHONPATH=src python -m repro_torch.launch.sim_run --device cpu \
        --ensemble 2 --devices 4 --mesh 2x2 --stepper block \
        --scenario plummer --n 64 --t-end 0.0625

``--backend {nccl,gloo}`` runs the ``--devices k`` shards (of a run under
a strategy, of an ensemble's batch, or of the ``--mesh`` grid) as k
processes over ``torch.distributed`` (``distributed.process_mesh``), every
rank running the whole loop on its slot; rank 0 writes the report and
prints the lines the in-process run prints.  nccl takes one card per rank
(more ranks than visible cards are refused before any process group
exists); gloo runs on the CPU, or stages the card's tensors through host
memory (every rank on ``cuda:0`` of a one-card host).  Where nothing is
sharded (``--devices 1``, or one run under ``--strategy single``) it is
refused:

    PYTHONPATH=src python -m repro_torch.launch.sim_run --device cpu \
        --backend gloo --devices 4 --strategy ring --stepper block \
        --scenario plummer --n 64 --t-end 0.0625

Each invocation emits a one-line summary plus a JSON telemetry report
(wall time, steps/s, interactions/s, modeled energy/EDP, per-run energy
conservation) under ``experiments/sim/`` (override with ``--out``).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.distributed import process_mesh
from repro_torch.sim import api, scenarios, telemetry


def _parse_params(pairs):
    """--param k=v (repeatable) -> dict with int/float coercion."""
    out = {}
    for pair in pairs or ():
        if "=" not in pair:
            raise SystemExit(f"--param expects k=v, got {pair!r}")
        k, v = pair.split("=", 1)
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", nargs="+", default=["plummer"],
                    help="one registry name, or several name:N tokens for a "
                         "mixed padded ensemble (e.g. king:256 merger:512)")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--pad", default=None,
                    help="mixed-ensemble padded size: 'auto' (largest member)"
                         " or an integer N_max")
    ap.add_argument("--kernel", default=None, choices=(None, "ref", "pallas"),
                    help="force kernel: 'pallas' (the device's own path) or "
                         "'ref' (the plain all-pairs version; cpu only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ensemble", type=int, default=1,
                    help="batch B independent runs (seeds seed..seed+B-1)")
    ap.add_argument("--t-end", type=float, default=1.0)
    ap.add_argument("--dt", type=float, default=None,
                    help="fixed step (single-run default: shared adaptive)")
    ap.add_argument("--stepper", default=None,
                    choices=(None, "fixed", "adaptive", "block"),
                    help="timestep mode: fixed dt, shared-adaptive (Aarseth) "
                         "lockstep, or hierarchical per-particle block "
                         "timesteps (default: fixed when --dt is given, "
                         "else adaptive)")
    ap.add_argument("--dt-max", type=float, default=0.0625,
                    help="coarsest timestep (adaptive cap / block level 0)")
    ap.add_argument("--levels", default="8",
                    help="block-timestep hierarchy depth (finest step is "
                         "dt_max / 2**(levels-1)), or 'auto' to size each "
                         "member from its initial Aarseth dt distribution "
                         "(clamped to [1, 8])")
    ap.add_argument("--compaction", default="none",
                    choices=("none", "gather"),
                    help="block stepper only: gather each event's active "
                         "targets into a dense block-aligned buffer and "
                         "launch the kernels on the shrunk grid (bit-for-bit "
                         "the masked result, far fewer tiles enqueued)")
    ap.add_argument("--bucket-mode", default="member",
                    choices=("member", "shared"),
                    help="capacity-bucket dispatch under --compaction "
                         "gather: 'member' groups ensemble members by their "
                         "n_active ceiling (a mixed batch's quiescent "
                         "members stop paying the widest member's grid), "
                         "'shared' is the batch-shared-bucket baseline")
    ap.add_argument("--block-i", type=int, default=None,
                    help="kernel target-tile rows (block stepper; default: "
                         "kernel's own — small N wants a smaller tile so "
                         "compaction has tiles to drop)")
    ap.add_argument("--block-j", type=int, default=None,
                    help="kernel source-tile columns (block stepper)")
    ap.add_argument("--sources", default="full",
                    choices=("full", "neighbor"),
                    help="block stepper force sources: 'full' (all-pairs) "
                         "or 'neighbor' (Ahmad-Cohen split: near force from "
                         "gathered per-block neighbor windows every event, "
                         "far field Taylor-predicted between refreshes)")
    ap.add_argument("--neighbor-radius", type=float, default=0.25,
                    help="neighbor window radius in simulation length units "
                         "(--sources neighbor; larger = more exact near "
                         "force, wider gathers)")
    ap.add_argument("--refresh-levels", type=int, default=2,
                    help="far-field refresh cadence: rebuild windows every "
                         "n_sub >> K ticks of the block hierarchy "
                         "(--sources neighbor; 0 = once per macro step)")
    ap.add_argument("--eta", type=float, default=0.02)
    ap.add_argument("--order", type=int, default=6, choices=(4, 6))
    ap.add_argument("--strategy", default="single",
                    choices=("single", "replicated", "two_level",
                             "mesh_sharded", "ring"))
    ap.add_argument("--devices", type=int, default=1,
                    help="shards of a run under --strategy, or of an "
                         "ensemble's batch: k CPU slots with --device cpu, "
                         "the first k cards on cuda")
    ap.add_argument("--backend", default=None, choices=process_mesh.BACKENDS,
                    help="run the --devices shards as processes over "
                         "torch.distributed with this backend")
    ap.add_argument("--mesh", default=None, metavar="BxP",
                    help="fused 2-D device grid for the block stepper, B "
                         "batch shards x P domain shards (B*P must equal "
                         "--devices)")
    ap.add_argument("--impl", default=None,
                    choices=(None, "pallas", "pallas_interpret", "xla",
                             "fp64"))
    ap.add_argument("--dtype", default="fp32",
                    choices=("fp64", "fp32", "mixed"),
                    help="precision axis: 'fp64' (the golden oracle, no "
                         "kernel), 'fp32' (the kernels' precision), or "
                         "'mixed' (bfloat16 per-pair arithmetic with "
                         "compensated fp32 accumulation)")
    ap.add_argument("--diag-every", type=int, default=16)
    ap.add_argument("--w0", type=float, default=None,
                    help="King concentration (sugar for --param w0=...)")
    ap.add_argument("--param", action="append", metavar="K=V",
                    help="scenario parameter, repeatable")
    ap.add_argument("--out", default=None, help="JSON report path")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "(nested macro-step -> event -> kernel-launch "
                         "spans; load at https://ui.perfetto.dev)")
    ap.add_argument("--metrics-interval", type=int, default=0,
                    help="attach a metrics-registry snapshot to every K-th "
                         "diagnostics record (0 = final snapshot only; the "
                         "report always carries the final one under "
                         "'metrics')")
    ap.add_argument("--no-validate", dest="validate", action="store_false",
                    help="skip construction-time scenario diagnostics")
    ap.add_argument("--list-scenarios", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the run's tensors live: 'cuda' (the "
                         "hand-written kernels; raises without a card) or "
                         "'cpu' (their plain versions)")
    args = ap.parse_args(argv)

    if args.list_scenarios:
        for name in scenarios.available():
            spec = scenarios.get_spec(name)
            print(f"{name:16s} {spec.description}  defaults={dict(spec.defaults)}")
        return 0

    params = _parse_params(args.param)
    if args.w0 is not None:
        params["w0"] = args.w0

    if args.levels == "auto":
        n_levels = None
    else:
        try:
            n_levels = int(args.levels)
        except ValueError:
            raise SystemExit(
                f"--levels expects an integer or 'auto', got {args.levels!r}"
            ) from None

    mesh = None
    if args.mesh is not None:
        try:
            b_sh, p_sh = (int(e) for e in args.mesh.lower().split("x"))
        except ValueError:
            raise SystemExit(
                f"--mesh expects BxP (e.g. 2x2), got {args.mesh!r}") \
                from None
        mesh = (b_sh, p_sh)

    # one token => homogeneous path (name:N is shorthand for --n N, so the
    # report keeps the real scenario label); several tokens => mixed padded
    # ensemble, bare names inheriting --n.  ScenarioSpec.parse validates at
    # the flag boundary (registry name, minimum N) with errors naming the
    # bad field — the same typed requests the serving layer admits.
    try:
        specs = [scenarios.ScenarioSpec.parse(t, seed=args.seed)
                 for t in args.scenario]
    except scenarios.ScenarioError as e:
        raise SystemExit(f"--scenario: {e}") from None
    mixed = len(specs) > 1
    if mixed:
        mix = tuple((s.name, s.with_n(args.n).n) for s in specs)
        scenario_name, n_arg = "mixed", max(n for _, n in mix)
    else:
        mix = None
        scenario_name = specs[0].name
        n_arg = specs[0].with_n(args.n).n
    pad = None
    if args.pad is not None:
        if not mixed:
            raise SystemExit("--pad only applies to mixed name:N ensembles")
        if args.pad != "auto":
            try:
                pad = int(args.pad)
            except ValueError:
                raise SystemExit(
                    f"--pad expects 'auto' or an integer, got {args.pad!r}") \
                    from None

    cfg = api.SimConfig(
        scenario=scenario_name, n=n_arg, seed=args.seed,
        ensemble=args.ensemble, t_end=args.t_end, dt=args.dt,
        stepper=args.stepper, dt_max=args.dt_max, n_levels=n_levels,
        compaction=args.compaction, bucket_mode=args.bucket_mode,
        block_i=args.block_i,
        block_j=args.block_j, sources=args.sources, mesh=mesh,
        neighbor_radius=args.neighbor_radius,
        refresh_levels=args.refresh_levels, eta=args.eta,
        order=args.order, strategy=args.strategy, devices=args.devices,
        impl=args.impl, kernel=args.kernel, dtype=args.dtype,
        mix=mix, pad=pad,
        diag_every=args.diag_every, scenario_params=params,
        validate_ic=args.validate,
        trace=args.trace, metrics_interval=args.metrics_interval,
        device=args.device,
        out=args.out or telemetry.default_report_path(
            {"scenario": scenario_name, "n": n_arg,
             "ensemble": args.ensemble if not mixed
             else len(mix) * args.ensemble,
             "strategy": args.strategy}),
    )
    if args.backend is not None:
        if args.devices < 2 or (args.strategy == "single" and not mixed
                                and args.ensemble == 1 and mesh is None):
            ap.error("--backend shards a --strategy, an ensemble or a --mesh "
                     "over --devices processes (at least 2); this run "
                     "shards nothing")
        process_mesh.spawn(_rank_run, args.devices, args.backend,
                           args.device, args.backend, cfg,
                           _lines(args, mesh, mix))
        return 0
    _print(api.run(cfg), *_lines(args, mesh, mix))
    return 0


def _lines(args, mesh, mix):
    """What the ``[sim]`` lines say of the command line."""
    return (dict(strategy=args.strategy, devices=args.devices,
                 order=args.order, dtype=args.dtype, sources=args.sources,
                 kernel=args.kernel), mesh, mix)


def _rank_run(device, backend, cfg, lines):
    """One rank of a process-mesh run (``process_mesh.spawn``): the whole
    run on this rank's slot; rank 0 writes the report and prints."""
    mesh = process_mesh.ProcessMesh(backend, device=device)
    first = mesh.rank == 0
    cfg = dataclasses.replace(cfg, device=str(device),
                              out=cfg.out if first else None,
                              trace=cfg.trace if first else None)
    report = api.run(cfg, mesh=mesh)
    if first:
        _print(report, *lines)


def _print(report, args, mesh, mix):
    desc = " ".join(f"{nm}:{n}" for nm, n in mix) if mix \
        else f"{report['scenario']} n={report['n']}"
    print(f"[sim] scenario={desc} "
          f"ensemble={report['ensemble']} strategy={args['strategy']} "
          f"devices={args['devices']} order={args['order']} "
          + (f"mesh={mesh[0]}x{mesh[1]} " if mesh else "")
          + f"stepper={report.get('stepper', 'fixed')} "
          f"dtype={args['dtype']}"
          + (f" sources={args['sources']}" if args['sources'] != "full"
             else "")
          + (f" kernel={args['kernel']}" if args['kernel'] else ""))
    if mix:
        print(f"[sim] padded N_max={report['n_bodies']} "
              f"n_active={report['n_active']}")
    print(f"[sim] t={report['t_final']:.4f} steps={report['steps']} "
          f"wall={report['wall_s']:.2f}s "
          f"steps/s={report['steps_per_s']:.1f} "
          f"pairs/s={report['interactions_per_s']:.3e}"
          + (f" force_evals={report['force_evals_total']:.3e}"
             if "force_evals_total" in report else "")
          + (f" grid_tiles={report['grid_tiles_total']:.3e}"
             if "grid_tiles_total" in report else ""))
    if "grid_tiles_per_shard" in report:
        shards = " ".join(f"{t:.0f}" for t in report["grid_tiles_per_shard"])
        print(f"[sim] grid_tiles_per_shard=[{shards}]")
    print(f"[sim] |dE/E|={report['de_rel']:.3e} "
          f"E_model={report['modeled']['energy_J']:.1f}J "
          f"EDP={report['modeled']['edp_Js']:.1f}Js")
    metrics = report.get("metrics") or {}
    counters = metrics.get("counters") or {}
    if counters:
        bits = " ".join(f"{k}={v['value']:g}"
                        for k, v in sorted(counters.items()))
        print(f"[sim] metrics: {bits}")
    if "trace_path" in report:
        print(f"[sim] trace -> {report['trace_path']}")
    print(f"[sim] report -> {report.get('report_path', '(not written)')}",
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
