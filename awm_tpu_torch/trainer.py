"""Epoch-level training loop (counterpart of awm_tpu/trainer.py).

fit() runs the epochs with per-term loss means, the mid-epoch quick
validation, select_metric (validated before training starts), early
stopping, the CSV metrics log and the loss-curve PNG.  With ckpt_dir it
writes ckpt_best on improvement of the select metric and ckpt_latest every
epoch, and resumes from ckpt_latest.  init_from starts from a checkpoint
directory or a flattened .npz (the fine-tune flow: weights only, missing
leaves kept at init, fresh optimizer and step).  Metrics are fetched one
step late, as the JAX loop does, so the card never waits on the host between
steps.  With an attack curriculum (cfg.augment.val_attacks) validation and
quick-val run under the curriculum's attacks.

With a mesh (parallel.make_mesh) every rank runs fit: the state is placed
on the mesh after any resume (parallel.shard_state), and every rank takes
rank 0's resume (its epoch, best value, step and Adam state), so a rank
that found no checkpoint of its own still runs the same epochs.  Each rank
walks the same global batch order and keeps its rows, and the step and
validation terms are global means, so early stopping and best-checkpoint
choices agree on every rank.  A validation batch keeps only the rows that
divide over the data axis (the last, partial batch loses its remainder;
the JAX package refuses it).  Rank 0 alone prints, logs, plots and writes
the checkpoints, which hold the whole message table and so restore on any
layout, one process included.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from awm_tpu_torch import checkpoint as ck
from awm_tpu_torch import train as tr
from awm_tpu_torch.config import Config
from awm_tpu_torch.losses import term_keys


class MetricsLogger:
    """CSV + in-memory per-epoch metric log."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.rows: List[Dict] = []
        self._fieldnames: Optional[List[str]] = None

    def log(self, row: Dict) -> None:
        self.rows.append(row)
        if self.path:
            write_header = self._fieldnames is None
            if write_header:
                self._fieldnames = list(row)
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames)
                if write_header:
                    w.writeheader()
                w.writerow({k: row.get(k) for k in self._fieldnames})


def _mean_terms(term_list: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: float(np.mean([t[k] for t in term_list])) for k in term_list[0]}


def _fetch(terms) -> Dict[str, float]:
    return {k: float(v) for k, v in terms.items()}


def _seeded(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def fit(
    cfg: Config,
    train_batches: Iterable,
    val_batches,
    *,
    epochs: Optional[int] = None,
    steps_per_epoch: Optional[int] = None,
    seed: int = 42,
    init_from: Optional[str] = None,
    log_path: Optional[str] = None,
    plot_path: Optional[str] = None,
    select_metric: Optional[str] = None,
    device="cuda",
    verbose: bool = True,
    ckpt_dir: Optional[str] = None,
    mesh=None,
) -> Dict:
    """Train gen + det jointly.  train_batches: a re-iterable of (B, T)
    float32 arrays (data.BatchLoader); val_batches: the same or None.

    select_metric: comma-separated validation loss keys (e.g. "loc,dec")
    whose sum drives best-checkpoint selection and early stopping instead
    of the weighted total.

    mesh: train on a ("data", "model") DeviceMesh, fed the global batches.

    Returns {state, history, best_val, stopped_early}."""
    import torch.distributed as dist

    from awm_tpu_torch.parallel import mesh as pm

    if mesh is not None and not dist.is_initialized():
        raise RuntimeError("fit(mesh=...) needs the mesh's process group: call "
                           "parallel.initialize_distributed, then parallel.make_mesh")
    lead = pm.is_lead(mesh)
    verbose = verbose and lead
    epochs = epochs if epochs is not None else cfg.train.epochs
    select_keys = [k.strip() for k in select_metric.split(",")] if select_metric else ["total"]
    unknown = [k for k in select_keys if k not in term_keys(cfg.loss)]
    if unknown:  # before training: a typo'd key would make val inf forever
        raise ValueError(
            f"select_metric key(s) {unknown} not in loss terms {list(term_keys(cfg.loss))}"
        )
    spe = steps_per_epoch or (len(train_batches) if hasattr(train_batches, "__len__") else 1000)
    state = tr.init_state(cfg, seed=seed, steps_per_epoch=spe, device=device)
    if plot_path:  # fail before training, not after it, where matplotlib is absent
        import matplotlib  # noqa: F401
    if init_from:  # weights only: the optimizer and step stay fresh
        ck.restore_params(init_from, state.gen, state.det, allow_missing=True)
    start_epoch, best_val = 0, float("inf")
    if ckpt_dir:
        state, start_epoch, best_val, resumed = ck.maybe_resume(ckpt_dir, state)
        if resumed and verbose:
            print(f"resumed from {ck.latest_path(ckpt_dir)} (next epoch = {start_epoch})")
    if mesh is not None:
        pm.shard_state(state, mesh)
        start_epoch, best_val = pm.lead_values([start_epoch, best_val], device)
        start_epoch = int(start_epoch)
    put = lambda b: torch.from_numpy(pm.shard_batch(np.asarray(b, np.float32), mesh)).to(device)
    data_n = pm.axis_size(mesh, "data")
    val_rows = lambda b: b[:len(b) - len(b) % data_n]  # the rows that divide over "data"

    early = tr.EarlyStopping(cfg.train.early_stop_patience, cfg.train.early_stop_min_delta)
    logger = MetricsLogger(log_path if lead else None)
    history: List[Dict] = []
    quick_every = cfg.train.quick_val_every
    val_iterable = val_batches if val_batches is not None else []
    val_iter = [None]  # cycling iterator: each quick-val sees the next val batch

    def next_val_batch():
        for _ in range(2):
            if val_iter[0] is None:
                val_iter[0] = iter(val_iterable)
            try:
                return next(val_iter[0])
            except StopIteration:
                val_iter[0] = None
        return None

    def val_attacks(i: int) -> Optional[torch.Generator]:
        # Seeded from the run seed and the batch index only, never the epoch:
        # every epoch's validation sees the same attack realisations, so the
        # select metric compares across epochs.
        if cfg.augment is not None and cfg.augment.val_attacks:
            return torch.Generator(device=device).manual_seed(seed + 70_000 + i)
        return None

    def run_validation() -> Dict[str, float]:
        # messages seeded by the batch index only: every epoch sees the same
        terms = [_fetch(tr.eval_step(cfg, state, put(b), generator=_seeded(seed + 7_000 + i),
                                     attack_generator=val_attacks(i)))
                 for i, b in enumerate(map(val_rows, val_iterable)) if len(b)]
        return _mean_terms(terms) if terms else {}

    stopped = False
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        train_terms: List[Dict[str, float]] = []
        pending = None  # fetch metrics one step late: keeps the card busy
        for i, batch in enumerate(train_batches):
            terms = tr.train_step(cfg, state, put(batch))
            if pending is not None:
                train_terms.append(_fetch(pending))
            pending = terms
            if quick_every and (i + 1) % quick_every == 0 and val_batches is not None:
                qb = next_val_batch()
                qb = None if qb is None else val_rows(qb)
                if qb is not None and len(qb):
                    qv = _fetch(tr.eval_step(cfg, state, put(qb), generator=_seeded(seed + 9_000 + i),
                                             attack_generator=val_attacks(i)))
                    if verbose:
                        print(f"  [quick-val @ step {i + 1}] total={qv['total']:.4f} "
                              f"mel={qv.get('mel', 0):.4f}")
        if pending is not None:
            train_terms.append(_fetch(pending))
        train_mean = _mean_terms(train_terms) if train_terms else {}

        val_mean = run_validation()
        src = val_mean or train_mean
        val_total = sum(src.get(k, float("inf")) for k in select_keys)
        row = {
            "epoch": epoch,
            "seconds": round(time.time() - t0, 2),
            **{f"train_{k}": v for k, v in train_mean.items()},
            **{f"val_{k}": v for k, v in val_mean.items()},
        }
        logger.log(row)
        history.append(row)
        if verbose:
            sel = "" if select_keys == ["total"] else f" select[{'+'.join(select_keys)}] {val_total:.4f}"
            print(f"epoch {epoch}: train {train_mean.get('total', float('nan')):.4f} "
                  f"val {src.get('total', float('nan')):.4f}{sel} ({row['seconds']}s)")
        if ckpt_dir:
            saved = dict(epoch=epoch + 1, model_cfg=cfg.model, shaping_cfg=cfg.shaping)
            if val_total < best_val:
                best_val = val_total
                ck.save_checkpoint(ck.best_path(ckpt_dir), state, best_val=best_val, **saved)
            ck.save_checkpoint(ck.latest_path(ckpt_dir), state, best_val=best_val, **saved)
        else:
            best_val = min(best_val, val_total)
        early.step(val_total)
        if early.early_stop:
            stopped = True
            if verbose:
                print(f"early stopping at epoch {epoch}")
            break

    if plot_path and history and lead:
        plot_curves(history, plot_path)
    return {"state": state, "history": history, "best_val": best_val, "stopped_early": stopped}


def plot_curves(history: List[Dict], path: str) -> None:
    """Loss-curve PNG of train_total and val_total by epoch (ref:
    py/main14d.py:629-641); matplotlib is imported here only."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = [h["epoch"] for h in history]
    plt.figure(figsize=(10, 6))
    for key in ("train_total", "val_total"):
        if key in history[0]:
            plt.plot(epochs, [h[key] for h in history], label=key)
    plt.xlabel("epoch")
    plt.ylabel("total loss")
    plt.legend()
    plt.grid(alpha=0.3)
    plt.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path)
    plt.close()
