#!/usr/bin/env python3
"""Which collectives gloo carries on CUDA tensors, for ranks that share
one card: plain ``torch.distributed`` calls, the functional collectives
that ``DTensor`` issues, and ``DTensor`` redistributions, on the world
group and on a (2, 2) ``DeviceMesh``'s sub-groups.

    python3 gloo_cuda_probe.py [cuda|cpu] [--staged]

Four gloo ranks (``repro_torch.distributed.process_mesh.spawn``) run each
check in order.  A check that crashes its rank (a segfault, as gloo gives
for a device pointer it reads as host memory) ends the spawn; the script
then notes the crash against the check the ranks had reached and spawns
again from the next one, so one crash does not hide the rest.  It prints
one ``PROBE <check> <result per rank>`` line per check (a crash as
``CRASH``).  ``--staged`` first routes the functional all-gather through
host memory (``process_mesh.stage_functional_all_gather``), as
``launch.mesh.make_device_mesh`` does for CUDA ranks under gloo.
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
NAMES = (["all_gather world", "reduce_scatter world", "all_gather data",
          "all_gather model", "reduce_scatter data", "reduce_scatter model",
          "all_reduce data", "all_to_all model", "scatter world"]
         + [f"functional {op} world" for op in OPS]
         + [f"functional {op} {g}" for op in OPS[1:]
            for g in ("model", "data")]
         + ["dtensor full_tensor", "dtensor distribute (each rank cuts)",
            "dtensor distribute (scatter from 0)"])


def checks(device):
    """[(name, fn)] in ``NAMES``' order: each fn returns a JSON value or
    raises."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    mesh = init_device_mesh(device.type, (2, 2),
                            mesh_dim_names=("data", "model"))
    data, model = mesh.get_group("data"), mesh.get_group("model")
    world = dist.group.WORLD
    x = torch.arange(32, dtype=torch.float32, device=device).reshape(8, 4) + 1
    full = torch.arange(64, dtype=torch.float32, device=device).reshape(8, 8)

    def all_gather(g):
        out = torch.empty(dist.get_world_size(g) * 8, 4, device=device)
        dist.all_gather_into_tensor(out, x, group=g)
        return True

    def reduce_scatter(g):
        n = dist.get_world_size(g)
        out = torch.empty(8 // n, 4, device=device)
        dist.reduce_scatter_tensor(out, x, group=g)
        return bool(torch.equal(out, n * x.chunk(n)[dist.get_rank(g)]))

    def all_reduce(g):
        t = x.clone()
        dist.all_reduce(t, group=g)
        return True

    def all_to_all(g):
        dist.all_to_all_single(torch.empty_like(x), x, group=g)
        return True

    def scatter():
        out = torch.empty(2, 4, device=device)
        parts = list(x.chunk(4)) if dist.get_rank() == 0 else None
        dist.scatter(out, parts, src=0)
        return True

    def functional(op, g):
        if op == "all_gather":
            out = funcol.all_gather_tensor(x, 0, g)
        elif op == "reduce_scatter":
            out = funcol.reduce_scatter_tensor(x, "sum", 0, g)
        elif op == "all_reduce":
            out = funcol.all_reduce(x, "sum", g)
        else:
            out = funcol.all_to_all_single(x, None, None, g)
        return list((out + 0).shape)

    def dtensor_full():
        local = full.chunk(2)[mesh.get_coordinate()[0]].contiguous()
        d = DTensor.from_local(local, mesh, [Shard(0), Replicate()])
        return bool(torch.equal(d.full_tensor(), full))

    def dtensor_distribute(src):
        d = distribute_tensor(full, mesh, [Shard(0), Shard(1)],
                              src_data_rank=src)
        return bool(torch.equal(d.full_tensor(), full))

    out = [("all_gather world", lambda: all_gather(None)),
           ("reduce_scatter world", lambda: reduce_scatter(None)),
           ("all_gather data", lambda: all_gather(data)),
           ("all_gather model", lambda: all_gather(model)),
           ("reduce_scatter data", lambda: reduce_scatter(data)),
           ("reduce_scatter model", lambda: reduce_scatter(model)),
           ("all_reduce data", lambda: all_reduce(data)),
           ("all_to_all model", lambda: all_to_all(model)),
           ("scatter world", scatter)]
    for op in OPS:
        out.append((f"functional {op} world",
                    lambda op=op: functional(op, world)))
    for op in OPS[1:]:
        for name, g in (("model", model), ("data", data)):
            out.append((f"functional {op} {name}",
                        lambda op=op, g=g: functional(op, g)))
    out += [("dtensor full_tensor", dtensor_full),
            ("dtensor distribute (each rank cuts)",
             lambda: dtensor_distribute(None)),
            ("dtensor distribute (scatter from 0)",
             lambda: dtensor_distribute(0))]
    assert [n for n, _ in out] == NAMES
    return out


def _append(path, line):
    with open(path, "a") as f:
        f.write(line + "\n")
        f.flush()
        os.fsync(f.fileno())


def rank_fn(device, out_dir, start, staged):
    """Each check from ``start`` on; the index reached and each result are
    written before the next check, so a crash loses nothing before it."""
    if staged:
        from repro_torch.distributed.process_mesh import (
            stage_functional_all_gather)
        stage_functional_all_gather(device.type.upper())
    rank = dist.get_rank()
    for i, (name, fn) in enumerate(checks(device)):
        if i < start:
            continue
        _append(os.path.join(out_dir, f"reached{rank}"), str(i))
        try:
            value = fn()
        except Exception as e:  # a refusal that raises is a result too
            value = f"raised {type(e).__name__}: {str(e)[:120]}"
        if device.type == "cuda":
            torch.cuda.synchronize()
        _append(os.path.join(out_dir, f"results{rank}"),
                json.dumps([name, value]))
        dist.barrier()


def main():
    from repro_torch.distributed import process_mesh

    device = next((a for a in sys.argv[1:] if not a.startswith("--")),
                  "cuda")
    staged = "--staged" in sys.argv
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {device} staged {staged}",
          flush=True)
    results = {name: [None] * 4 for name in NAMES}
    start = 0
    while start < len(NAMES):
        with tempfile.TemporaryDirectory(prefix="gloo_probe_") as out:
            try:
                process_mesh.spawn(rank_fn, 4, "gloo", device, out, start,
                                   staged)
                crashed = None
            except Exception as e:  # a rank that crashed ends the spawn
                crashed = str(e).strip().splitlines()[0][:80]
            reached = [start]
            for r in range(4):
                for path, fill in ((f"results{r}", True), (f"reached{r}",
                                                           False)):
                    path = os.path.join(out, path)
                    if not os.path.exists(path):
                        continue
                    for line in open(path).read().splitlines():
                        if fill:
                            name, value = json.loads(line)
                            results[name][r] = value
                        else:
                            reached.append(int(line))
        if crashed is None:
            break
        bad = max(reached)
        results[NAMES[bad]] = [f"CRASH ({crashed})"] * 4
        start = bad + 1
    for name in NAMES:
        print(f"PROBE {name}: {json.dumps(results[name])}", flush=True)


if __name__ == "__main__":
    main()
