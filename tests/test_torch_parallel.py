"""The port's multi-process training (parallel/mesh.py) vs the JAX package.

In process, a world of one over gloo: the mesh and its sharding rules, the
refusal of cuda without NCCL, and fit(mesh=) equal to fit().  Spawned on the
CPU over gloo, each rank a process, as on several cards:
- 2 ranks, data=2: the shapecap fp32 train step against the JAX package's
  single-device step, and one robust step with the state's own draws and the
  per-bit dec weights against the same step in one process, gradients
  included;
- 2 ranks, model=2: fit resumed where rank 0 alone finds the checkpoint,
  against the same resume in one process;
- 4 ranks, data 2 x model 2 (awm_tpu_torch/tools/multihost_drill.py): two
  steps of the base preset with its message table sharded, from the JAX
  package's init, against the JAX single-device steps;
- torchrun --nproc-per-node 2 -m awm_tpu_torch train --data-parallel
  --device cpu (data=2) with --ckpt-dir and a validation split that does
  not divide, resumed in one process.

Every spawned rank meets the others through a file in tmp_path (no fixed
port), and every subprocess has a timeout.  The JAX references are computed
while the ranks run.  Tolerances are stated per test."""

import dataclasses
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
import optax

import torch_assets as ta
import torch_parallel_worker as pw

from awm_tpu_torch import train as tr
from awm_tpu_torch.config import get_config
from awm_tpu_torch.parallel import (full_grads, initialize_distributed, make_mesh, param_spec,
                                    shard_batch, state_shardings)
from awm_tpu_torch.trainer import fit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
T_STEP = 800


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _spawn(spec, tmp_path, world):
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    return [subprocess.Popen([sys.executable, WORKER, str(path), str(r), str(world)], env=_env(),
                             cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _wait(procs, timeout=300):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)


@pytest.fixture
def world_of_one(tmp_path):
    assert initialize_distributed(f"file://{tmp_path}/rdzv", 1, 0, device="cpu") == 1
    yield
    dist.destroy_process_group()


# -- in process -----------------------------------------------------------------


def test_mesh_and_sharding_rules(world_of_one, tmp_path):
    """make_mesh over the world, its refusals, idempotent initialisation, and
    param_spec / state_shardings as tests/test_parallel.py:27-45 states them:
    the table's rows over "model", everything else replicated."""
    assert initialize_distributed(f"file://{tmp_path}/other", 1, 0, device="cpu") == 1
    mesh = make_mesh()
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(model_parallel=2)
    with pytest.raises(ValueError, match="world size"):
        make_mesh(2)
    state = tr.init_state(pw.fit_config(256), device="cpu")
    specs = state_shardings(state, mesh)
    assert specs["gen.embedding.weight"] == ("model", None)
    assert {k for k, v in specs.items() if v} == {"gen.embedding.weight"}
    assert param_spec("det.conv_in.weight", state.det.conv_in.weight, mesh) == ()
    assert param_spec("gen.embedding.weight", torch.zeros(7, 4), mesh) == ("model", None)
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(shard_batch(x, mesh), x)


def test_cuda_without_nccl_raises():
    """No fallback: a cuda group needs NCCL (this build has none)."""
    if dist.is_nccl_available():
        pytest.skip("this torch build has NCCL")
    with pytest.raises(RuntimeError, match="NCCL"):
        initialize_distributed(device="cuda")
    assert not dist.is_initialized()


def test_fit_on_a_mesh_of_one_equals_fit(world_of_one, tmp_path):
    """fit(mesh=) on a world of one: the same history and the same state,
    bit for bit, as fit(); its checkpoint holds the whole table."""
    cfg = pw.fit_config(256)
    runs = [fit(cfg, *pw.fit_loaders(cfg, 8, 6), epochs=1, device="cpu", verbose=False, mesh=m,
                ckpt_dir=str(tmp_path / f"c{i}"))
            for i, m in enumerate((None, make_mesh()))]
    a = runs[0]["state"]
    for run in runs[1:]:
        assert run["history"][0].keys() == runs[0]["history"][0].keys()
        for k, v in runs[0]["history"][0].items():
            assert k == "seconds" or run["history"][0][k] == v, k
        b = run["state"]
        assert b.mesh is not None and a.step == b.step == 3
        for net in ("gen", "det"):
            sa, sb = getattr(a, net).state_dict(), getattr(b, net).state_dict()
            assert all(torch.equal(sa[k], sb[k]) for k in sa), net
    saved = torch.load(tmp_path / "c1" / "ckpt_latest" / "torch_state.pt", weights_only=True)
    assert saved["gen"]["embedding.weight"].shape == (2**16, 64)


# -- 2 ranks, data=2 ---------------------------------------------------------------


def _named(state, what):
    out = {}
    for net in ("gen", "det"):
        out.update({f"{net}.{k}": v.detach().numpy()
                    for k, v in getattr(getattr(state, net), f"named_{what}")()})
    return out


def test_data_parallel_steps(tmp_path):
    """2 ranks on a data=2 mesh, one row each (T=800), against one process on
    both rows, each held by torch_parallel_worker.check_step, the rules of
    test_fp32_train_step_matches_jax: gradients within 5e-3 of each
    parameter's largest (a BatchNorm-fed conv bias, zero analytically,
    below 1e-3 of the largest gradient); parameters within 1e-2 lr where the
    gradient is clearly nonzero, within 2 lr elsewhere.
    - Clean fp32 step from the shapecap weights with the JAX step's message,
      against the JAX package's step (its loss function's gradients and
      optax's Adam update): terms 1e-5 relative, BatchNorm statistics 1e-5.
      A BatchNorm that took its own rank's statistics or dropped the
      other rank's share of the gradient, or SyncBatchNorm's unbiased
      running variance, fails these.
    - Robust fp32 step under the C_robust curriculum with dec bit balance 1,
      every draw the state's own from (seed, step), against the port's step
      in one process: terms 1e-5 relative, the same gradient and parameter
      rules, statistics 1e-5.  Per-rank draws, a wrong cut of the [s_w; s]
      detector rows, or per-rank bit weights each change the terms well
      beyond that.
    Both ranks report the same terms, gradients and state, bit for bit."""
    s = ta.golden_inputs(ta.TRAIN_SEED, 2)[0][:, :T_STEP]
    clean_in, robust_in = tmp_path / "clean.npz", tmp_path / "robust.npz"
    np.savez(robust_in, s=s)
    robust = {"name": "robust", "inputs": str(robust_in), "audio_len": T_STEP,
              "augment": ta.ROBUST_AUGMENT, "bit_balance": 1.0}

    # the JAX step's message goes to the ranks; its step runs while they do
    cfg_j = ta.train_config(audio_len=T_STEP)
    jstate, gen, det, tx = ta.jax_state_from_npz(cfg_j)
    message = ta.jax_message(cfg_j, jstate, 2, seed=0)
    np.savez(clean_in, s=s, messages=np.asarray(message)[None])
    spec = {"url": f"file://{tmp_path}/rdzv", "out": str(tmp_path), "jobs": [
        {"name": "clean", "inputs": str(clean_in), "audio_len": T_STEP}, robust]}
    procs = _spawn(spec, tmp_path, 2)
    try:
        jterms, grads, new_bs = ta.jax_loss_and_grads(cfg_j, gen, det, jstate, jnp.asarray(s), message)
        updates, _ = tx.update(grads, jstate.opt_state, jstate.params)
        ref = {"terms": {k: float(v) for k, v in jterms.items()},
               "step": {**ta.torch_named({"params": optax.apply_updates(jstate.params, updates)}),
                        **{f"grad.{k}": v for k, v in ta.torch_named({"params": grads}).items()}},
               "batch_stats": ta.torch_named({"batch_stats": new_bs})}
        rcfg = pw.job_config(robust)
        one = pw.job_state(rcfg)
        one_terms = {k: float(v) for k, v in tr.train_step(rcfg, one, torch.from_numpy(s)).items()}
        one_state = {**_named(one, "parameters"), **_named(one, "buffers"),
                     **{f"grad.{k}": v.numpy() for k, v in full_grads(one).items()}}
    finally:
        _wait(procs)
    ranks = {n: [dict(np.load(tmp_path / f"{n}.{r}.npz")) for r in range(2)] for n in ("clean", "robust")}
    lr = get_config("base").train.schedule.lr
    params = sorted(_named(one, "parameters"))
    for name, ref_terms, ref_step, ref_stats in (
            ("clean", ref["terms"], ref["step"], ref["batch_stats"]),
            ("robust", one_terms, one_state, {k: one_state[k] for k in ref["batch_stats"]})):
        got = ranks[name][0]
        assert ranks[name][1].keys() == got.keys()
        for k, v in ranks[name][1].items():
            np.testing.assert_array_equal(v, got[k], err_msg=f"{name}: ranks differ at {k}")
        for k, v in ref_terms.items():
            np.testing.assert_allclose(float(got[f"term0/{k}"]), v, rtol=1e-5, err_msg=f"{name} {k}")
        assert sorted(k for k in got if k.startswith("grad.")) == [f"grad.{k}" for k in params]
        pw.check_step(got, ref_step, lr, params)
        for k, v in ref_stats.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=f"{name} {k}")


# -- 2 ranks, model=2: a resume that rank 0 alone finds -----------------------------


def test_resume_takes_rank_zeros_checkpoint(tmp_path):
    """fit on 2 ranks (model=2, the base preset's table sharded), each with
    its own --ckpt-dir as on two hosts: rank 0's holds a checkpoint that one
    process wrote after epoch 0, rank 1's is empty.  Both ranks resume at
    epoch 1 with rank 0's step and Adam state, and end equal, bit for bit,
    to each other and to the same resume in one process on one thread, as
    each rank runs: the same history, parameters, statistics and Adam
    moments (the table and its moments gathered).  A model=2 step is the
    one-process step: the lookup's sum adds zeros, and the mean of two equal
    gradients is each.  Rank 0 alone writes the epoch's checkpoint, with the
    whole table."""
    import shutil

    cfg = pw.fit_config(256)
    first = str(tmp_path / "first")
    fit(cfg, *pw.fit_loaders(cfg, 8, 6), epochs=1, device="cpu", verbose=False, ckpt_dir=first)
    dirs = [str(tmp_path / f"rank{r}") for r in range(2)]
    shutil.copytree(first, dirs[0])
    os.makedirs(dirs[1])
    job = {"name": "fit", "kind": "fit", "audio_len": 256, "n": 8, "n_train": 6, "epochs": 2,
           "ckpt_dirs": dirs}
    procs = _spawn({"url": f"file://{tmp_path}/rdzv", "out": str(tmp_path), "model_parallel": 2,
                    "jobs": [job]}, tmp_path, 2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' summation order
    try:
        one = fit(cfg, *pw.fit_loaders(cfg, 8, 6), epochs=2, device="cpu", verbose=False,
                  ckpt_dir=first)
    finally:
        torch.set_num_threads(threads)
        _wait(procs, timeout=120)
    assert [h["epoch"] for h in one["history"]] == [1] and one["state"].step == 6
    want = {**_named(one["state"], "parameters"), **_named(one["state"], "buffers")}
    order = list(_named(one["state"], "parameters"))
    for i, p in enumerate(one["state"].optimizer.param_groups[0]["params"]):
        for key, v in one["state"].optimizer.state[p].items():
            want[f"{key}.{order[i]}"] = v.numpy()
    for r in range(2):
        got = dict(np.load(tmp_path / f"fit.{r}.npz"))
        history = json.load(open(tmp_path / f"fit.{r}.json"))
        assert int(got["step"]) == 6 and float(got["best_val"]) == one["best_val"], r
        assert [h["epoch"] for h in history] == [1], r
        for k, v in one["history"][0].items():
            assert k == "seconds" or history[0][k] == v, (r, k)
        assert got.keys() - {"step", "best_val"} == want.keys(), r
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"rank {r}: {k}")
    assert os.listdir(dirs[1]) == []
    saved = torch.load(os.path.join(dirs[0], "ckpt_latest", "torch_state.pt"), weights_only=True)
    assert saved["gen"]["embedding.weight"].shape == (2**16, 64) and saved["step"] == 6


# -- 4 ranks, data 2 x model 2: the drill ------------------------------------------


def test_multihost_drill_matches_jax(tmp_path):
    """The port's drill (4 processes, data 2 x model 2, the base preset's
    2^16 x 64 table sharded) from the JAX package's init and with its
    messages, against two JAX single-device train steps (fp32, B=8, T=512):
    terms 1e-3 relative and every parameter after both steps, the gathered
    table included, within 5e-3, as tests/test_parallel.py:47-75 holds the
    JAX mesh; the first step's gradients, the gathered table's too, against
    the JAX step's loss function's by torch_parallel_worker.check_grads
    (5e-3 of each parameter's largest).
    The drill's own checks must all be true: identical terms on the four
    ranks, the one-process run's terms and table gradient norm (a table
    gradient summed over the model group is twice that), the table
    sharded."""
    from awm_tpu import train as jtr
    from awm_tpu.config import get_config as jget

    from awm_tpu_torch.tools import multihost_drill as drill

    cfg = dataclasses.replace(jget("base"), audio_len=drill.AUDIO_LEN)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    state, gen, det = jtr.init_state(cfg, jax.random.key(0))
    init, msgs = tmp_path / "init.npz", tmp_path / "messages.npz"
    np.savez(init, **ta.flatten({"params": ta.jax_to_np(state.params),
                                 "batch_stats": ta.jax_to_np(state.batch_stats)}))
    messages = {}
    for step in range(drill.STEPS):
        st = state.replace(step=jnp.asarray(step, jnp.int32))
        messages[f"step{step}"] = np.asarray(ta.jax_message(cfg, st, drill.GLOBAL_BATCH, seed=0))
    np.savez(msgs, **messages)
    proc = subprocess.Popen([sys.executable, "-m", "awm_tpu_torch.tools.multihost_drill",
                             "--init", str(init), "--messages", str(msgs), "--out-dir",
                             str(tmp_path)], env=_env(), cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        tx = jtr.make_optimizer(cfg)
        batch = jnp.asarray(drill.global_batch())
        _, grads, _ = ta.jax_loss_and_grads(cfg, gen, det, state, batch, jnp.asarray(messages["step0"]))
        first_grads = {f"grad.{k}": v for k, v in ta.torch_named({"params": grads}).items()}
        terms = []
        for _ in range(drill.STEPS):
            state, t = jtr.train_step(cfg, gen, det, tx, state, batch, jax.random.key(0))
            terms.append({k: float(v) for k, v in t.items()})
        ref = ta.torch_named({"params": state.params})
    finally:
        out, _ = proc.communicate(timeout=300)
        proc.kill()
    assert proc.returncode == 0, out[-4000:]
    summary = json.loads(out[out.rindex('{\n  "ok"'):])
    assert summary["ok"] and all(summary["checks"].values()), summary
    assert summary["table"] == {"spec": ["model", None], "local_rows": 2**15, "global_rows": 2**16}
    got = json.load(open(tmp_path / "drill.0.json"))
    for step, ref_terms in enumerate(terms):
        for k, v in ref_terms.items():
            np.testing.assert_allclose(got["steps"][step]["terms"][k], v, rtol=1e-3, err_msg=(step, k))
    params = dict(np.load(tmp_path / "drill.npz"))
    assert params["gen.embedding.weight"].shape == params["grad.gen.embedding.weight"].shape == (2**16, 64)
    assert sorted(k for k in params if k.startswith("grad.")) == sorted(f"grad.{k}" for k in ref)
    for k, v in ref.items():
        assert np.abs(params[k] - v).max() < 5e-3, k
    pw.check_grads(params, first_grads, list(ref))


# -- torchrun + the train command ----------------------------------------------------


def test_torchrun_train_resumes_in_one_process(tmp_path):
    """torchrun --nproc-per-node 2 -m awm_tpu_torch train --data-parallel
    --device cpu (data=2, one row a rank; the base preset) with --ckpt-dir:
    one line of output, rank 0's.  The validation split's 3 clips make
    batches of 2 and 1: the first validates on both ranks, the second does
    not divide over data=2 and is left out, where shard_batch would raise.
    A checkpoint with the whole table, which a second call in one process
    resumes at epoch 1."""
    import csv

    from awm_tpu_torch.__main__ import main

    ckpt, log = str(tmp_path / "ck"), str(tmp_path / "log.csv")
    argv = ["train", "--device", "cpu", "--audio-len", "256", "--batch-size", "2",
            "--synthetic-n", "30", "--workers", "0", "--compute-dtype", "float32",
            "--ckpt-dir", ckpt]
    p = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", "-m", "awm_tpu_torch"] + argv
                         + ["--epochs", "1", "--data-parallel", "--log-csv", log],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env(),
                         cwd=REPO, start_new_session=True)
    try:
        out = p.communicate(timeout=300)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)  # the ranks too, not only torchrun
        raise
    assert p.returncode == 0, out[-6000:]
    assert out.count('"best_val"') == 1 and out.count("epoch 0:") == 1, out
    rows = list(csv.DictReader(open(log)))
    assert len(rows) == 1 and np.isfinite(float(rows[0]["val_total"])), rows
    saved = torch.load(os.path.join(ckpt, "ckpt_latest", "torch_state.pt"), weights_only=True)
    assert saved["gen"]["embedding.weight"].shape == (2**16, 64) and saved["step"] == 12
    out = main(argv + ["--epochs", "2"])
    assert [h["epoch"] for h in out["history"]] == [1] and out["state"].step == 24
    assert out["state"].mesh is None


def test_curriculum_passes_the_mesh_flags(tmp_path, monkeypatch):
    """curriculum --data-parallel --model-parallel K hands both flags to every
    leg's train command (each leg is one main() call)."""
    from awm_tpu_torch import __main__ as cli

    legs = []
    def leg(argv):  # what a leg's train command leaves: its checkpoint directory
        legs.append(argv)
        os.makedirs(argv[argv.index("--ckpt-dir") + 1])

    monkeypatch.setattr(cli, "main", leg)
    cli.cmd_curriculum(cli.parse_args(["curriculum", "robust_decode", "--out", str(tmp_path),
                                       "--smoke", "--data-parallel", "--model-parallel", "2",
                                       "--stop-after", "B_dilated"]))
    assert len(legs) == 2
    for argv in legs:
        i = argv.index("--data-parallel")
        assert argv[0] == "train" and argv[i + 1:i + 3] == ["--model-parallel", "2"]
