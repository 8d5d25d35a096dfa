#!/usr/bin/env python
"""Multi-process drill: the real train step across 4 processes on the CPU
(counterpart of tools/multihost_drill.py).

Four OS processes join one gloo group and one global ("data", "model") = (2,
2) mesh, the layout of two hosts of two cards with the message table
sharded inside each host.  What it checks:
- initialize_distributed wires 4 processes; make_global_mesh lays them out
  (2, 2) with each model group two consecutive ranks;
- the message table is sharded over "model" ("model", None): each process
  holds half its rows;
- each process feeds only its own rows (shard_batch_from_process_local);
  the row means summed over the data group give the global batch's, row for
  row (batch_assembly_exact);
- two train steps of the base preset (T=512, B=8, fp32): the four
  processes report identical loss terms, which match the port's own
  one-process run of the same two steps within fp32 summation order (1e-3
  relative), and so does the table's gradient norm (a table gradient summed
  over the model group would be twice the one process's).

    python -m awm_tpu_torch.tools.multihost_drill [--init NPZ] [--messages NPZ] [--out-dir D]

--init starts both runs from a flattened {'params', 'batch_stats'} .npz
(checkpoint.load_into) instead of the seed-0 init; --messages holds the
messages of each step (step0, step1) instead of the state's draws; --out-dir
keeps each run's result and state (the whole table gathered), with the
first step's gradients under "grad.<name>", for a caller to hold against
another package.  Prints one summary JSON; exits 1 unless every check
holds.  Internal modes: worker RANK WORLD URL OUT, ref OUT.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

N_PROC = 4
MODEL_PARALLEL = 2
AUDIO_LEN = 512  # a short chunk: the CPU's plain LSTM, not the model's width, sets the cost
GLOBAL_BATCH = 8
STEPS = 2


def _cfg():
    from awm_tpu_torch.config import get_config

    cfg = get_config("base")
    return dataclasses.replace(cfg, audio_len=AUDIO_LEN,
                               train=dataclasses.replace(cfg.train, compute_dtype="float32"))


def global_batch() -> np.ndarray:
    rng = np.random.default_rng(0)
    return (rng.standard_normal((GLOBAL_BATCH, AUDIO_LEN)) * 0.3).astype(np.float32)


def _table_grad_norm(state) -> float:
    """Norm of the whole table's gradient: the shards' squared sums summed
    over the model group."""
    from awm_tpu_torch.parallel.collectives import all_reduce_

    emb = state.gen.embedding
    sq = emb.weight.grad.double().square().sum().reshape(1)
    return float(all_reduce_(sq, emb.group).sqrt())


def run_steps(mesh, init=None, messages=None, out=None) -> dict:
    """The two train steps on this process's rows of the global batch (all
    of it without a mesh); returns the per-step terms and the checks'
    readings, and with `out` saves the state, table gathered, to out.npz."""
    import torch

    from awm_tpu_torch import train as tr
    from awm_tpu_torch.checkpoint import load_into
    from awm_tpu_torch.parallel import (full_grads, full_state_dicts, shard_batch_from_process_local,
                                        shard_state)
    from awm_tpu_torch.parallel.collectives import all_reduce_
    from awm_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size, param_spec

    cfg = _cfg()
    state = tr.init_state(cfg, seed=0, device="cpu")
    if init:
        load_into(state.gen, state.det, init)
    if mesh is not None:
        shard_state(state, mesh)
    g = global_batch()
    rows = GLOBAL_BATCH // axis_size(mesh, "data")
    lo = axis_index(mesh, "data") * rows
    batch = shard_batch_from_process_local(torch.from_numpy(g[lo:lo + rows]), mesh)
    means = torch.zeros(GLOBAL_BATCH, dtype=torch.float64)
    means[lo:lo + rows] = batch.double().mean(dim=1)
    all_reduce_(means, axis_group(mesh, "data"))
    msgs = np.load(messages) if messages else None
    steps = []
    for step in range(STEPS):
        message = torch.from_numpy(msgs[f"step{step}"]).long() if msgs is not None else None
        terms = tr.train_step(cfg, state, batch, message=message)
        steps.append({"terms": {k: float(v) for k, v in terms.items()},
                      "table_grad_norm": _table_grad_norm(state)})
        if step == 0:
            grads = full_grads(state)
    table = state.gen.embedding.weight
    res = {"steps": steps,
           "losses": [s["terms"]["total"] for s in steps],
           "assembly_err": float((means - torch.from_numpy(g).double().mean(dim=1)).abs().max()),
           "table_spec": list(param_spec("gen.embedding.weight", table, mesh)) if mesh else [],
           "table_local_rows": int(table.shape[0]),
           "table_global_rows": int(table.shape[0] * axis_size(mesh, "model"))}
    sds = full_state_dicts(state)
    if out:
        np.savez(out + ".npz", **{f"{net}.{k}": v.numpy() for net in ("gen", "det")
                                  for k, v in sds[net].items()},
                 **{f"grad.{k}": v.numpy() for k, v in grads.items()})
    return res


def run_worker(rank: int, world: int, url: str, out: str, init, messages) -> None:
    import torch
    import torch.distributed as dist

    from awm_tpu_torch.parallel import initialize_distributed, make_global_mesh

    torch.set_num_threads(1)
    n = initialize_distributed(url, world, rank, device="cpu")
    mesh = make_global_mesh(model_parallel=MODEL_PARALLEL)
    res = run_steps(mesh, init, messages, out if rank == 0 else None)
    res.update(process_id=rank, process_count=n,
               mesh={"data": mesh["data"].size(), "model": mesh["model"].size()},
               model_group=sorted(dist.get_process_group_ranks(mesh.get_group("model"))))
    with open(out + f".{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def run_parent(init=None, messages=None, out_dir=None) -> int:
    from awm_tpu_torch.parallel.spawn import spawn_ranks

    with tempfile.TemporaryDirectory() as d:
        keep = out_dir or d
        os.makedirs(keep, exist_ok=True)
        extra = (["--init", init] if init else []) + (["--messages", messages] if messages else [])
        url = "file://" + os.path.join(d, "rendezvous")
        me = ["-m", "awm_tpu_torch.tools.multihost_drill"]
        argvs = {f"worker{i}": me + ["worker", str(i), str(N_PROC), url, os.path.join(keep, "drill")] + extra
                 for i in range(N_PROC)}
        argvs["ref"] = me + ["ref", os.path.join(keep, "single")] + extra
        t0 = time.time()
        try:
            spawn_ranks(argvs, d, timeout=240, env={"OMP_NUM_THREADS": "1"})
        except RuntimeError as e:
            print(json.dumps({"ok": False, "fails": [str(e)]}))
            return 1
        ws = [_read_json(os.path.join(keep, f"drill.{i}.json")) for i in range(N_PROC)]
        single = _read_json(os.path.join(keep, "single.json"))

    def close(a, b):
        return abs(a - b) <= 1e-3 * max(1.0, abs(b))

    checks = {
        "process_count": all(w["process_count"] == N_PROC for w in ws),
        "mesh_layout": all(w["mesh"] == {"data": N_PROC // MODEL_PARALLEL, "model": MODEL_PARALLEL}
                           and w["model_group"] == [w["process_id"] // 2 * 2, w["process_id"] // 2 * 2 + 1]
                           for w in ws),
        "losses_identical_across_processes": all(w["steps"] == ws[0]["steps"] for w in ws),
        "batch_assembly_exact": all(w["assembly_err"] <= 1e-6 for w in ws),
        "table_sharded": all(w["table_spec"] == ["model", None]
                             and w["table_local_rows"] * MODEL_PARALLEL == w["table_global_rows"]
                             for w in ws),
        "matches_single_process": all(
            close(a["table_grad_norm"], b["table_grad_norm"])
            and all(close(a["terms"][k], v) for k, v in b["terms"].items())
            for a, b in zip(ws[0]["steps"], single["steps"])),
    }
    summary = {"ok": all(checks.values()), "checks": checks,
               "losses_multiprocess": ws[0]["losses"], "losses_single_process": single["losses"],
               "table_grad_norms": [[s["table_grad_norm"] for s in r["steps"]] for r in (ws[0], single)],
               "table": {"spec": ws[0]["table_spec"], "local_rows": ws[0]["table_local_rows"],
                         "global_rows": ws[0]["table_global_rows"]},
               "seconds": round(time.time() - t0, 2)}
    print(json.dumps(summary, indent=2))
    return 0 if summary["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="*", help="worker RANK WORLD URL OUT | ref OUT (internal)")
    ap.add_argument("--init")
    ap.add_argument("--messages")
    ap.add_argument("--out-dir")
    args = ap.parse_args(argv)
    if args.mode[:1] == ["worker"]:
        rank, world, url, out = args.mode[1:]
        run_worker(int(rank), int(world), url, out, args.init, args.messages)
        return 0
    if args.mode[:1] == ["ref"]:
        import torch

        torch.set_num_threads(1)
        res = run_steps(None, args.init, args.messages, args.mode[1])
        with open(args.mode[1] + ".json", "w") as f:
            json.dump(res, f)
        return 0
    return run_parent(args.init, args.messages, args.out_dir)


if __name__ == "__main__":
    sys.exit(main())
