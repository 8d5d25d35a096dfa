"""Entry points of the port: the counterparts of the repo root's
__graft_entry__.py, ``entry`` (:18-44) and ``dryrun_multichip`` (:47-135).

- entry(device=None, variables=None) -> (fn, example_args): the base
  preset's forward at its seed-0 init, fn(s, message) -> (s_w, logits) with
  s_w = s + gen(s, message) and logits = det(cat([s_w, s])), both networks
  in inference mode (running BatchNorm statistics) at the preset's compute
  dtype (bf16 convs, fp32 parameters, as the JAX entry builds them).  On a
  card the generator's LSTM runs kernel A at width 64.
- dryrun_multichip(n, device=None): n ranks over gloo on an ("data",
  "model") mesh, (n / 2, 2) when n is even, else (n, 1).  Each rank runs one
  train step of the base preset at audio_len=512 with its 2^16 x 64 message
  table cut over the model axis, on its rows of a 2n-clip batch, then the
  sharded LSTM gradient check: x (B=n, T=32, D=16) cut over the data axis,
  each rank's d/dx of sum(sin(lstm(x))) through LSTMFunction (kernels B and
  C at width 16 on a card), held against the plain version of the whole
  batch on one process within 1e-4 (the JAX threshold).  n = 1 runs in this
  process; more ranks are processes of their own (parallel.spawn_ranks),
  met through a file rendezvous, with a deadline, every one killed when one
  fails.  On a card the ranks share it (gloo carries the collectives of
  CUDA tensors).  Any failed check raises.

    python -m awm_tpu_torch.entry [--dryrun N] [--device cpu]

runs entry()'s function on its example arguments and prints the output
shapes, or with --dryrun the dry run on N ranks (its line, as the JAX one
prints it).  Both run on cuda unless --device cpu.  Internal mode: ``rank
SPEC RANK`` (one rank of a dry run, SPEC its dry_spec as JSON); run_dry
runs a dry_spec with the options that tests use (a given init and
messages, rank 0's state and gradients kept).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

AUDIO_LEN = 512  # the dry run's chunk (__graft_entry__.py:89)
LSTM_T, LSTM_D = 32, 16  # the dry run's LSTM check (__graft_entry__.py:117)
GRAD_TOL = 1e-4  # its bound on the sharded gradient's max abs error (:126)


def _base_config(compute_dtype: str | None, **changes):
    """The base preset with `changes`, at compute_dtype (None: the preset's)."""
    from awm_tpu_torch.config import get_config

    cfg = dataclasses.replace(get_config("base"), **changes)
    if compute_dtype is None:
        return cfg
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype=compute_dtype))


def _require(ok: bool, what: str) -> None:
    """A check of the dry run that holds under python -O too."""
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def entry(device=None, variables=None, compute_dtype: str | None = None):
    """(fn, example_args): fn(s, message) maps (B, 16000) fp32 clips and (B,)
    int64 messages to (s_w (B, 16000), logits (2B, 16000, 17)), both fp32,
    with no gradient.  The weights are train.init_state(get_config("base"),
    seed=0)'s, or `variables`: a flax-layout tree of numpy arrays,
    {"params": {"gen", "det"}, "batch_stats": {"gen", "det"}}, taken through
    checkpoint.variables_from_flax.  compute_dtype overrides the preset's
    (bfloat16).  The example arguments are four zero clips and messages on
    the device (cuda unless `device` says otherwise)."""
    import torch

    from awm_tpu_torch import train as tr
    from awm_tpu_torch.checkpoint import variables_from_flax
    from awm_tpu_torch.utils.precision import no_tf32

    dev = torch.device(device or "cuda")
    cfg = _base_config(compute_dtype)
    state = tr.init_state(cfg, seed=0, device=dev)
    gen, det = state.gen, state.det
    if variables is not None:
        for name, net in (("gen", gen), ("det", det)):
            tree = {part: variables[part][name] for part in ("params", "batch_stats") if part in variables}
            net.load_state_dict(variables_from_flax(tree), strict=True)
    gen.eval()
    det.eval()

    @torch.no_grad()
    def forward(s, message):
        with no_tf32():
            s_w = s + gen(s, message).to(torch.float32)
            logits = det(torch.cat([s_w, s], dim=0)).to(torch.float32)
        return s_w, logits

    example_args = (torch.zeros(4, cfg.audio_len, dtype=torch.float32, device=dev),
                    torch.zeros(4, dtype=torch.int64, device=dev))
    return forward, example_args


def mesh_shape(n: int) -> dict:
    """The dry run's ("data", "model") layout of n ranks."""
    model = 2 if n % 2 == 0 else 1
    return {"data": n // model, "model": model}


def dry_batch(n: int) -> np.ndarray:
    """The dry run's global batch: 2n clips of AUDIO_LEN samples, N(0, 0.1^2)."""
    rng = np.random.default_rng(1)
    return (rng.standard_normal((2 * n, AUDIO_LEN)) * 0.1).astype(np.float32)


def lstm_check_inputs(n: int) -> tuple[np.ndarray, ...]:
    """x (n, LSTM_T, LSTM_D) N(0, 0.3^2), then w_ih, w_hh (4D, D) and b (4D)
    N(0, 0.1^2), as __graft_entry__.py:118-122 draws them."""
    rng = np.random.default_rng(3)
    d = LSTM_D
    x = rng.standard_normal((n, LSTM_T, d)) * 0.3
    w_ih, w_hh = (rng.standard_normal((4 * d, d)) * 0.1 for _ in range(2))
    b = rng.standard_normal(4 * d) * 0.1
    return tuple(a.astype(np.float32) for a in (x, w_ih, w_hh, b))


def run_rank(spec: dict, rank: int) -> None:
    """One rank of the dry run (spec: dry_spec's); writes
    <out>/rank<rank>.json, and with spec["keep"] rank 0 also writes
    <out>/state.npz: every parameter after the step and its gradient
    ("grad.<name>"), each sharded table gathered whole."""
    import torch
    import torch.distributed as dist

    from awm_tpu_torch import train as tr
    from awm_tpu_torch.checkpoint import load_into
    from awm_tpu_torch.ops import lstm_kernel as K
    from awm_tpu_torch.ops.lstm import lstm_forward
    from awm_tpu_torch.parallel import (full_grads, full_state_dicts, initialize_distributed,
                                        make_global_mesh, shard_batch, shard_state, shutdown)
    from awm_tpu_torch.parallel.collectives import all_reduce_
    from awm_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size
    from awm_tpu_torch.utils.precision import no_tf32

    n, dev = spec["n"], torch.device(spec["device"])
    if dev.type == "cuda":  # every rank on the one card
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        raise RuntimeError("a dry run's rank joins a group of its own: this process is in one already")
    before = dict(K.launches)
    initialize_distributed(spec["url"], n, rank, device=dev, backend="gloo")
    try:
        mesh = make_global_mesh(model_parallel=mesh_shape(n)["model"])
        cfg = _base_config(spec.get("compute_dtype"), audio_len=AUDIO_LEN)
        state = tr.init_state(cfg, seed=0, device=dev)
        if spec.get("init"):
            missing = load_into(state.gen, state.det, spec["init"])
            _require(not missing, f"rank {rank}: the init left {missing} at their initial values")
        shard_state(state, mesh)
        rows = torch.from_numpy(shard_batch(dry_batch(n), mesh)).to(dev)
        message = None
        if spec.get("messages"):
            message = torch.from_numpy(np.load(spec["messages"])).long().to(dev)
        terms = {k: float(v) for k, v in tr.train_step(cfg, state, rows, message=message).items()}
        _require(bool(np.isfinite(terms["total"])), f"rank {rank}: non-finite loss {terms['total']}")
        _require(state.step == 1, f"rank {rank}: step {state.step} after one train step")
        table = state.gen.embedding
        lo = table.vocab_start
        keep = {}
        if spec.get("keep"):  # collectives: every rank gathers
            sds = full_state_dicts(state)
            keep = {f"{net}.{k}": v.cpu().numpy() for net in ("gen", "det") for k, v in sds[net].items()}
            keep.update({f"grad.{k}": v.cpu().numpy() for k, v in full_grads(state).items()})

        # the sharded LSTM gradient: this rank's rows of x through
        # LSTMFunction, the data shards summed into the whole batch's dx
        x, w_ih, w_hh, b = lstm_check_inputs(n)
        xs = torch.from_numpy(shard_batch(x, mesh)).to(dev).requires_grad_()
        ws = [torch.from_numpy(a).to(dev) for a in (w_ih, w_hh, b)]
        with no_tf32():
            (dx,) = torch.autograd.grad(torch.sin(K.LSTMFunction.apply(xs, *ws)).sum(), xs)
        full = torch.zeros(x.shape, dtype=torch.float32, device=dev)
        share = x.shape[0] // axis_size(mesh, "data")
        full[axis_index(mesh, "data") * share:][:share] = dx
        all_reduce_(full, axis_group(mesh, "data"))
        xr = torch.from_numpy(x).requires_grad_()
        (ref,) = torch.autograd.grad(
            torch.sin(lstm_forward(xr, *(torch.from_numpy(a) for a in (w_ih, w_hh, b)))).sum(), xr)
        err = float((full.cpu() - ref).abs().max())
        res = {"rank": rank, "mesh": {"data": axis_size(mesh, "data"), "model": axis_size(mesh, "model")},
               "terms": terms, "step": state.step, "table_rows": [lo, lo + int(table.weight.shape[0])],
               "lstm_grad_err": err, "launches": {k: v - before[k] for k, v in K.launches.items()}}
        if rank == 0 and keep:
            np.savez(os.path.join(spec["out"], "state.npz"), **keep)
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        shutdown()


def dry_spec(n: int, device, out: str, **options) -> dict:
    """The options of one dry run on n ranks, writing to the directory out:
    compute_dtype (None: the preset's bfloat16), init (a flattened
    {'params', 'batch_stats'} .npz, checkpoint.load_into, in place of the
    seed-0 init), messages (a .npy of the 2n global messages in place of the
    state's draw) and keep (rank 0 also writes out/state.npz: every
    parameter after the step and its gradient)."""
    return {"n": n, "device": str(device or "cuda"), "out": out,
            "url": "file://" + os.path.join(out, "rendezvous"), **options}


def run_dry(spec: dict, timeout: float = 900.0) -> dict:
    """Run the ranks of a dry_spec (rank 0 in this process when there is one
    rank; else one process each, met through the file rendezvous, every one
    stopped at the first that fails or at `timeout` seconds), check what
    they report, print the dry run's line and return its numbers."""
    n, out = spec["n"], spec["out"]
    if n < 1:
        raise ValueError(f"dryrun_multichip needs at least one rank, got {n}")
    os.makedirs(out, exist_ok=True)
    if spec["device"].startswith("cuda"):  # built once here, not by every rank at once
        from awm_tpu_torch.ops import cuda_build, lstm_kernel

        cuda_build.build_all(lstm_kernel.SOURCES)
    if n == 1:
        run_rank(spec, 0)
    else:
        from awm_tpu_torch.parallel.spawn import spawn_ranks

        spec_path = os.path.join(out, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env = {"OMP_NUM_THREADS": "1"} if spec["device"] == "cpu" else {}  # n ranks share the cores
        try:
            spawn_ranks({f"rank{r}": ["-m", "awm_tpu_torch.entry", "rank", spec_path, str(r)] for r in range(n)},
                        out, timeout, env)
        except RuntimeError as e:
            raise RuntimeError(f"dryrun_multichip: {e}") from None
    ranks = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    want = mesh_shape(n)
    total = ranks[0]["terms"]["total"]
    err = max(r["lstm_grad_err"] for r in ranks)
    model = want["model"]
    table_rows = [ranks[i]["table_rows"] for i in range(model)]
    _require(all(r["mesh"] == want for r in ranks), f"meshes {[r['mesh'] for r in ranks]}, not {want}")
    _require(all(r["terms"]["total"] == total for r in ranks),
             f"the ranks' losses differ: {[r['terms']['total'] for r in ranks]}")
    _require(all(r["table_rows"] == table_rows[r["rank"] % model] for r in ranks)
             and table_rows[0][0] == 0 and all(a[1] == b[0] for a, b in zip(table_rows, table_rows[1:])),
             f"the table's rows per rank {[r['table_rows'] for r in ranks]} do not cut it over the model axis")
    _require(err < GRAD_TOL, f"sharded LSTM grad mismatch: {err}")
    print(f"dryrun_multichip OK: mesh={want} loss={total:.4f} (embedding table sharded over model: rows "
          f"{', '.join(f'[{a}, {b})' for a, b in table_rows)}; sharded LSTM grad err {err:.2e})", flush=True)
    return {"mesh": want, "loss": total, "terms": ranks[0]["terms"], "table_rows": table_rows,
            "lstm_grad_err": err, "launches": [r["launches"] for r in ranks]}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded train step on n_devices ranks at the preset's bf16 and
    the sharded LSTM gradient check, as the module doc says.  device:
    "cuda" (the default; every rank on the one card) or "cpu".  Prints one
    line and returns {"mesh", "loss", "terms", "table_rows" (per model
    rank), "lstm_grad_err", "launches" (per rank)}.  Raises if a rank fails
    or a check does not hold."""
    with tempfile.TemporaryDirectory() as out:
        return run_dry(dry_spec(n_devices, device, out))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["rank"]:
        with open(argv[1]) as f:
            run_rank(json.load(f), int(argv[2]))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", type=int, default=None, metavar="N", help="the dry run on N ranks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.dryrun is not None:
        dryrun_multichip(args.dryrun, args.device)
        return 0
    fn, example_args = entry(args.device)
    print("entry OK:", tuple(tuple(t.shape) for t in fn(*example_args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
