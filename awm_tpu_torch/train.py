"""Jointly trained generator + detector: the train step (counterpart of
awm_tpu/train.py).

One step runs the generator, the delta shaping, the channel, the attack
curriculum (cfg.augment) on the concatenated [watermarked; clean] 2B batch,
the detector on that batch, every loss term, the
backward (through the hand-written LSTM backward kernel on the card) and one
Adam step over both networks' parameters.  PyTorch's idiom replaces JAX's
pure functions: the step updates the TrainState's modules, optimizer and
BatchNorm statistics in place, and returns the loss terms as device tensors
that the caller fetches when it wants (trainer.fit fetches them one step
late, so the card is never waiting on the host).

Messages are drawn from an explicit torch.Generator on the CPU (the
state's, or the caller's), the attacks from one on the step's device, so the
noise is made where it is used.  train_step reseeds the state's two from
(seed, step) before it draws, as the JAX step folds the step into its key
(awm_tpu/train.py:183): a run resumed from a checkpoint draws what an
uninterrupted one would, and a checkpoint holds no random state.
train_step and eval_step also take a message tensor and the attack draws,
which the parity tests use to hand in what the JAX step drew.  The two
frameworks' random streams are never compared.

Under a mesh (parallel.shard_state puts it in state.mesh) s holds this
rank's rows of the global batch, and the step is the step on the global
batch: every rank draws the global batch's messages and attacks from the
same (seed, step) generators and keeps its rows, BatchNorm and dec_loss's
bit weights take statistics over the data group, the gradients are averaged
before Adam (a table shard's over the data group, every other one over all
ranks, which keeps the replicated parameters bit-equal), and the returned
terms are the global means.  A message or attack draws handed in are the
global batch's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from awm_tpu_torch.augment import apply_augment, draw_augment
from awm_tpu_torch.config import Config
from awm_tpu_torch.losses import total_loss
from awm_tpu_torch.parallel.collectives import all_reduce_, group_size, mean_over_ranks
from awm_tpu_torch.parallel.mesh import axis_group, axis_size, shard_batch, world_group
from awm_tpu_torch.models import (
    build_models,
    decode_bits_majority,
    decode_bits_mean_logit,
    message_to_bits,
)
from awm_tpu_torch.models.layers import Embedding
from awm_tpu_torch.shaping import apply_channel, shape_delta
from awm_tpu_torch.utils.precision import no_tf32


@dataclasses.dataclass
class TrainState:
    """Both networks (parameters fp32, BN statistics as buffers), the Adam
    optimizer over the trained parameters, the learning-rate schedule, the
    step count, the run seed, the message generator (CPU) and the attack
    generator (on the networks' device); train_step seeds both from (seed,
    step).  mesh: the DeviceMesh of a state placed by parallel.shard_state,
    None on one process."""

    gen: torch.nn.Module
    det: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    generator: torch.Generator
    attack_generator: torch.Generator
    seed: int = 42
    step: int = 0
    mesh: Optional[object] = None


def compute_dtype_of(cfg: Config) -> Optional[torch.dtype]:
    """TrainConfig.compute_dtype as a torch dtype (None = fp32)."""
    name = cfg.train.compute_dtype
    if name in (None, "float32", "fp32"):
        return None
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"unknown compute_dtype {name!r}")


def make_schedule(cfg: Config, steps_per_epoch: int = 1000) -> Callable[[int], float]:
    """step -> learning rate.  "constant", or "onecycle": optax's
    cosine_onecycle_schedule (cosine from max_lr/div_factor up to max_lr
    over pct_start of the steps, then down to max_lr/(div_factor *
    final_div_factor)), with the JAX package's clamp (awm_tpu/train.py:59-77):
    a phase of zero steps would make every value NaN, so pct_start must lie
    in (0, 1) and the total is raised until both phases have a step."""
    sch = cfg.train.schedule
    if sch.kind == "constant":
        return lambda step: sch.lr
    if sch.kind != "onecycle":
        raise ValueError(f"unknown schedule {sch.kind!r}")
    if not 0.0 < sch.pct_start < 1.0:
        raise ValueError(f"onecycle pct_start must be in (0, 1), got {sch.pct_start}")
    total = steps_per_epoch * cfg.train.epochs
    total = max(total, math.ceil(1.0 / min(sch.pct_start, 1.0 - sch.pct_start)), 2)
    bounds = (0, int(sch.pct_start * total), int(total))
    init = sch.max_lr / sch.div_factor
    values = (init, init * sch.div_factor, init / sch.final_div_factor)

    def schedule(step: int) -> float:
        for k in range(2):
            if bounds[k] <= step < bounds[k + 1]:
                pct = (step - bounds[k]) / (bounds[k + 1] - bounds[k])
                start, end = values[k], values[k + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)
        return values[2]

    return schedule


def make_optimizer(cfg: Config, gen, det, schedule) -> torch.optim.Adam:
    """One Adam over gen + det (optax.adam's defaults).  freeze = "gen" or
    "det" leaves that network's parameters out (and stops their gradients),
    so only the other one trains."""
    frozen = cfg.train.freeze
    if frozen not in (None, "gen", "det"):
        raise ValueError(f"TrainConfig.freeze must be 'gen', 'det' or None, got {frozen!r}")
    params = []
    for name, net in (("gen", gen), ("det", det)):
        if name == frozen:
            net.requires_grad_(False)
        else:
            params += list(net.parameters())
    return torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)


def init_state(
    cfg: Config, *, seed: int = 42, steps_per_epoch: int = 1000, device="cuda"
) -> TrainState:
    """Fresh networks (torch's initialisers, drawn under `seed`), on device,
    with the optimizer and schedule of cfg.  Load trained weights into
    state.gen / state.det (checkpoint.restore_params) before the first step."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gen, det = build_models(cfg.model, compute_dtype=compute_dtype_of(cfg))
    gen, det = gen.to(device), det.to(device)
    schedule = make_schedule(cfg, steps_per_epoch)
    return TrainState(gen=gen, det=det, optimizer=make_optimizer(cfg, gen, det, schedule),
                      schedule=schedule, generator=torch.Generator().manual_seed(seed),
                      attack_generator=torch.Generator(device=device).manual_seed(seed), seed=seed)


def seed_step(state: TrainState) -> None:
    """Seed the state's message and attack generators from (seed, step), two
    streams apart."""
    base = (state.seed * 1_000_003 + state.step) % 2**62
    state.generator.manual_seed(2 * base)
    state.attack_generator.manual_seed(2 * base + 1)


def draw_messages(cfg: Config, n: int, generator: torch.Generator, device) -> torch.Tensor:
    """n uniform cfg.message_bits-bit messages from a CPU generator."""
    return torch.randint(0, 2**cfg.message_bits, (n,), generator=generator).to(device)


def _precision(cfg: Config):
    """The fp32 step is true fp32 on the card (TF32 off); bf16 needs nothing."""
    return no_tf32() if compute_dtype_of(cfg) is None else contextlib.nullcontext()


def _forward(cfg: Config, gen, det, s, message, *, train: bool, attack_draws=None):
    """generator -> shaping -> channel -> attacks -> detector
    (awm_tpu/train.py:130-168).  Returns (delta, s_w, logits), all fp32; in
    train mode the BatchNorm layers update their running statistics as a
    side effect.  attack_draws (augment.draw_augment for the 2B detector
    batch) turns cfg.augment on; None leaves the batch clean."""
    gen.train(train)
    det.train(train)
    delta = shape_delta(gen(s, message).to(torch.float32), cfg.shaping, cfg.sample_rate)
    s_w = s + delta
    if cfg.shaping.clamp_watermarked:
        s_w = s_w.clamp(-1.0, 1.0)
    s_w = apply_channel(s_w, cfg.shaping, cfg.sample_rate)
    combined = torch.cat([s_w, s], dim=0)
    if cfg.augment is not None and attack_draws is not None:
        # Both halves of the detector batch are attacked: attacking only the
        # watermarked half lets the detector use the attack's artifacts as
        # the label cue (awm_tpu/train.py:152-156).
        combined = apply_augment(combined, attack_draws, cfg.augment)
    logits = det(combined)
    return delta, s_w, logits.to(torch.float32)


def _terms(cfg, s, delta, s_w, logits, message, group=None):
    return total_loss(cfg.loss, s=s, s_w=s_w, delta=delta, logits=logits, message=message,
                      message_bits=cfg.message_bits, group=group)


def _draw_attacks(cfg: Config, batch: int, length: int, generator: Optional[torch.Generator]):
    """The attack draws of one step for the (2 * batch, length) detector
    batch, or None without a curriculum or a generator."""
    if cfg.augment is None or generator is None:
        return None
    return draw_augment(cfg.augment, 2 * batch, length, generator)


def _own_rows(mesh, message, attack_draws):
    """This rank's rows of the global batch's draws: its shard of the B
    messages, and of each half of the 2B detector rows cat([s_w, s])."""
    if axis_size(mesh, "data") == 1:
        return message, attack_draws
    if attack_draws is not None:
        big = message.shape[0]
        attack_draws = {k: torch.cat([shard_batch(v[:big], mesh), shard_batch(v[big:], mesh)])
                        for k, v in attack_draws.items()}
    return shard_batch(message, mesh), attack_draws


def _mean_grads(grads, group) -> None:
    """Each gradient replaced by its mean over the group: one all-reduce of
    a flat copy."""
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, group).div_(group_size(group))
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def _average_grads(state: TrainState) -> None:
    """The gradients of the global batch's loss.  A sharded table's rows
    differ over the model group, so its gradient is averaged over the data
    group.  Every other leaf is replicated: its mean over all ranks is the
    data group's mean where the ranks of a model group agree, and it leaves
    the copies bit-equal where a nondeterministic reduction on the card
    makes them differ, so they cannot drift apart step after step."""
    params = [p for g in state.optimizer.param_groups for p in g["params"] if p.grad is not None]
    sharded = {id(mod.weight) for net in (state.gen, state.det) for mod in net.modules()
               if isinstance(mod, Embedding) and mod.group is not None}
    _mean_grads([p.grad for p in params if id(p) not in sharded], world_group(state.mesh))
    _mean_grads([p.grad for p in params if id(p) in sharded], axis_group(state.mesh, "data"))


def _global_terms(terms: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Detached loss terms, each the mean over the group of the ranks' means
    (the global batch's mean: the ranks hold equal shares)."""
    if group is None:
        return {k: v.detach() for k, v in terms.items()}
    means = mean_over_ranks(torch.stack([v.detach().float() for v in terms.values()]), group)
    return dict(zip(terms, means.unbind()))


def train_step(cfg: Config, state: TrainState, s: torch.Tensor,
               message: Optional[torch.Tensor] = None,
               attack_draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step on a (B, T) batch of clean clips, on s's device.
    Draws the messages from state.generator unless `message` is given, and
    with cfg.augment this step's attacks from state.attack_generator unless
    `attack_draws` is given, both seeded from (state.seed, state.step).  Updates state in place; returns the loss terms
    (detached device scalars).  A frozen network still normalises with its
    batch statistics but keeps its running statistics, as the JAX step does."""
    seed_step(state)
    big = s.shape[0] * axis_size(state.mesh, "data")
    if message is None:
        message = draw_messages(cfg, big, state.generator, s.device)
    if attack_draws is None:
        attack_draws = _draw_attacks(cfg, big, s.shape[1], state.attack_generator)
    message, attack_draws = _own_rows(state.mesh, message, attack_draws)
    data = axis_group(state.mesh, "data")
    frozen = {"gen": state.gen, "det": state.det}.get(cfg.train.freeze)
    kept = [b.clone() for b in frozen.buffers()] if frozen is not None else []
    with _precision(cfg):
        delta, s_w, logits = _forward(cfg, state.gen, state.det, s, message, train=True,
                                      attack_draws=attack_draws)
        terms = _terms(cfg, s, delta, s_w, logits, message, data)
        state.optimizer.zero_grad(set_to_none=True)
        terms["total"].backward()
        _average_grads(state)
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        state.optimizer.step()
    if frozen is not None:
        with torch.no_grad():
            for buf, old in zip(frozen.buffers(), kept):
                buf.copy_(old)
    state.step += 1
    return _global_terms(terms, data)


@torch.no_grad()
def eval_step(cfg: Config, state: TrainState, s: torch.Tensor,
              message: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              attack_generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Validation: the same loss terms without grad, BatchNorm in eval mode.
    Messages from `generator` (or `message`).  With cfg.augment and an
    attack_generator (on s's device) the detector batch goes through the
    curriculum's attacks, so the terms measure detection under attack; None
    validates clean.  Clean loc/dec have converged when a robustness
    fine-tune starts, and selecting on them would freeze the run at epoch 0
    (awm_tpu/train.py:235-240)."""
    big = s.shape[0] * axis_size(state.mesh, "data")
    if message is None:
        message = draw_messages(cfg, big, generator, s.device)
    message, draws = _own_rows(state.mesh, message,
                               _draw_attacks(cfg, big, s.shape[1], attack_generator))
    data = axis_group(state.mesh, "data")
    with _precision(cfg):
        delta, s_w, logits = _forward(cfg, state.gen, state.det, s, message, train=False,
                                      attack_draws=draws)
        return _global_terms(_terms(cfg, s, delta, s_w, logits, message, data), data)


@torch.no_grad()
def evaluate_step(cfg: Config, state: TrainState, s: torch.Tensor,
                  message: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Quality metrics per example: detection probability of both halves,
    bit accuracy by per-step majority vote and by the time-mean logit, and
    the delta RMS."""
    b = s.shape[0]
    if message is None:
        message = draw_messages(cfg, b * axis_size(state.mesh, "data"), generator, s.device)
    message, _ = _own_rows(state.mesh, message, None)
    with _precision(cfg):
        delta, _, logits = _forward(cfg, state.gen, state.det, s, message, train=False)
    probs = torch.sigmoid(logits[:, :, 0]).mean(dim=1)
    target = message_to_bits(message, cfg.message_bits)
    bit_logits = logits[:b, :, 1:]
    return {
        "watermarked_prob": probs[:b],
        "clean_prob": probs[b:],
        "bit_accuracy": (decode_bits_majority(bit_logits) == target).float().mean(dim=1),
        "bit_accuracy_mean_logit": (decode_bits_mean_logit(bit_logits) == target).float().mean(dim=1),
        "delta_rms": delta.square().mean(dim=1).sqrt(),
    }


class EarlyStopping:
    """patience / min_delta early stop on the validation metric."""

    def __init__(self, patience: int = 3, min_delta: float = 0.001):
        self.patience = patience
        self.min_delta = min_delta
        self.best_loss = float("inf")
        self.counter = 0
        self.early_stop = False

    def step(self, val_loss: float) -> None:
        if self.best_loss - val_loss > self.min_delta:
            self.best_loss = val_loss
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
