"""One rank of the spawned tests of tests/test_torch_parallel.py (and of the
card case in tests/test_torch_gpu.py): the port's train step on a sharded
state, over gloo, on the CPU or on one card for every rank.

    PYTHONPATH=. python tests/torch_parallel_worker.py SPEC.json RANK WORLD

SPEC holds the rendezvous URL, the device, the model-parallel size, the
output directory and a list of jobs.  A step job builds a TrainState (the
shapecap weights), places it on the mesh, and runs train steps on this
rank's rows of the global batch it reads from an .npz (with the global
messages, where given).  Each rank writes <out>/<job>.<rank>.npz: the terms
of every step, the parameters (the message table gathered whole) and
BatchNorm statistics after the last, and that step's averaged gradients
under "grad.<name>".  A fit job (kind "fit") runs trainer.fit on the base
preset's tiny config with its own checkpoint directory for each rank, and
writes the history, the step and the state dicts with Adam's moments.
Imports the port only, as a process of a multi-card run would.

check_step holds such a step against a reference step; the tests that read
the ranks' files call it.
"""

import dataclasses
import json
import os
import re
import sys

import numpy as np
import torch

from awm_tpu_torch import train as tr
from awm_tpu_torch.augment import AugmentConfig
from awm_tpu_torch.checkpoint import (SHAPECAP_ARCH, SHAPECAP_NPZ, configs_from_arch, load_into,
                                      read_arch)
from awm_tpu_torch.config import get_config
from awm_tpu_torch.parallel import (full_grads, full_state_dicts, initialize_distributed, make_mesh,
                                    shard_batch, shard_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# conv biases that feed a train-mode BatchNorm: zero gradient analytically
BN_FED = re.compile(r"res\w*\.conv[12]\.bias$")


def check_grads(got, want, params) -> dict:
    """Gradients ("grad.<name>" of got and want) by
    test_torch_train.py::test_fp32_train_step_matches_jax's rules: within
    5e-3 of the parameter's largest reference gradient; a BatchNorm-fed conv
    bias (analytically zero) below 1e-3 of the largest gradient of all.
    Returns each other parameter's largest difference; raises
    AssertionError naming the parameter."""
    gmax = max(np.abs(want[f"grad.{k}"]).max() for k in params)
    diffs = {}
    for k in params:
        g, ref_g = np.asarray(got[f"grad.{k}"]), np.asarray(want[f"grad.{k}"])
        if BN_FED.search(k):
            assert np.abs(g).max() < 1e-3 * gmax, (k, np.abs(g).max() / gmax)
            continue
        diffs[k] = np.abs(g - ref_g).max()
        assert diffs[k] < 5e-3 * np.abs(ref_g).max(), (k, diffs[k] / np.abs(ref_g).max())
    return diffs


def check_step(got, want, lr, params) -> None:
    """One train step's gradients and updated parameters against a
    reference step from the same weights, batch and draws.  got and want map
    each parameter's name to its value after the step and "grad.<name>" to
    its gradient; params names the parameters.  The gradients by
    check_grads; the parameters within 1e-2 lr wherever the reference
    gradient is 100x the gradients' difference, and within 2 lr elsewhere
    (gradients within rounding of zero, whose sign Adam's first step
    amplifies to +-lr).  Raises AssertionError naming the parameter."""
    diffs = check_grads(got, want, params)
    for k in params:
        step_err = np.abs(np.asarray(got[k]) - np.asarray(want[k]))
        assert step_err.max() <= 2 * lr + 1e-7, (k, step_err.max())
        if k in diffs:
            sure = np.abs(np.asarray(want[f"grad.{k}"])) > 100 * diffs[k]
            assert sure.any() and step_err[sure].max() < 1e-2 * lr, (k, step_err[sure].max() / lr)


def job_config(job):
    """The job's Config: the shapecap architecture and shaping with the base
    preset's losses (--dec-loss mean, the job's bit balance), fp32, with the
    curriculum whose fields job["augment"] holds."""
    cfg = get_config("base")
    model, shaping = configs_from_arch(read_arch(SHAPECAP_ARCH))
    loss = dataclasses.replace(cfg.loss, dec_loss_mode="mean",
                               dec_bit_balance=job.get("bit_balance", 0.0))
    augment = AugmentConfig(**job["augment"]) if job.get("augment") else None
    return dataclasses.replace(cfg, model=model, shaping=shaping, loss=loss, augment=augment,
                               audio_len=job["audio_len"],
                               train=dataclasses.replace(cfg.train, compute_dtype="float32"))


def job_state(cfg, device="cpu"):
    """A TrainState from the shapecap weights."""
    state = tr.init_state(cfg, device=device)
    assert load_into(state.gen, state.det, SHAPECAP_NPZ) == []
    return state


def run_job(job, mesh, out: str, device) -> None:
    cfg = job_config(job)
    state = shard_state(job_state(cfg, device), mesh)
    with np.load(job["inputs"]) as f:
        s, messages = f["s"], (f["messages"] if "messages" in f.files else None)
    rows = torch.from_numpy(shard_batch(s, mesh)).to(device)
    saved = {}
    for step in range(job.get("steps", 1)):
        message = None if messages is None else torch.from_numpy(messages[step]).long().to(device)
        terms = tr.train_step(cfg, state, rows, message=message)
        saved.update({f"term{step}/{k}": float(v) for k, v in terms.items()})
    saved.update({f"grad.{k}": v.cpu().numpy() for k, v in full_grads(state).items()})
    sds = full_state_dicts(state)
    for net in ("gen", "det"):
        saved.update({f"{net}.{k}": v.cpu().numpy() for k, v in sds[net].items()})
    np.savez(out, **saved)


def fit_config(audio_len: int):
    """The base preset (its 2^16 x 64 message table) at a short length, fp32."""
    cfg = get_config("base")
    return dataclasses.replace(cfg, audio_len=audio_len,
                               train=dataclasses.replace(cfg.train, compute_dtype="float32"))


def fit_loaders(cfg, n: int, n_train: int):
    """(train, val) BatchLoaders of 2 clips over n synthetic clips, the
    first n_train for training."""
    from awm_tpu_torch.data import BatchLoader, SyntheticClips

    ds = SyntheticClips(n=n, audio_len=cfg.audio_len)
    mk = lambda idx, sh: BatchLoader(ds, 2, indices=idx, shuffle=sh, drop_last=sh, seed=0)
    return mk(range(n_train), True), mk(range(n_train, n), False)


def run_fit(job, mesh, rank: int, out: str, device) -> None:
    from awm_tpu_torch.trainer import fit

    cfg = fit_config(job["audio_len"])
    res = fit(cfg, *fit_loaders(cfg, job["n"], job["n_train"]), epochs=job["epochs"], device=device,
              verbose=False, mesh=mesh, ckpt_dir=job["ckpt_dirs"][rank])
    sds = full_state_dicts(res["state"])
    saved = {f"{net}.{k}": v.cpu().numpy() for net in ("gen", "det") for k, v in sds[net].items()}
    order = [f"{net}.{k}" for net in ("gen", "det") for k, _ in getattr(res["state"], net).named_parameters()]
    for i, moments in sds["optimizer"]["state"].items():
        saved.update({f"{key}.{order[i]}": v.cpu().numpy() for key, v in moments.items()})
    np.savez(out, step=res["state"].step, best_val=res["best_val"], **saved)
    with open(out[:-len(".npz")] + ".json", "w") as f:
        json.dump(res["history"], f)


def main():
    spec_path, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    device = torch.device(spec.get("device", "cpu"))
    initialize_distributed(spec["url"], world, rank, device=device, backend="gloo")
    mesh = make_mesh(model_parallel=spec.get("model_parallel", 1))
    for job in spec["jobs"]:
        out = os.path.join(spec["out"], f"{job['name']}.{rank}.npz")
        if job.get("kind") == "fit":
            run_fit(job, mesh, rank, out, device)
        else:
            run_job(job, mesh, out, device)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
