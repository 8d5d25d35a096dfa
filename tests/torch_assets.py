"""Build the PyTorch port's packaged assets from the JAX package.

The files under ``awm_tpu_torch/assets/`` come from here:

- ``shapecap.npz``: the shapecap checkpoint (``evidence/r5/shapecap/ckpt_best``)
  restored through ``awm_tpu.checkpoint.restore_params`` and flattened to
  ``/``-joined keys (``params/gen/enc_conv/w``, ``batch_stats/det/res1/bn1/mean``).
  The port loads weights from this file, since it reads no orbax tree.
- ``shapecap_golden.npz``: the JAX package's fp32 serving outputs on 8
  seeded chunks (``embed_chunks`` deltas with the shapecap shaping chain and
  the ``embed_detect`` summaries), plus the chunks and messages themselves.

- ``train_golden.npz``: one fp32 JAX train step's loss terms, gradient norms
  and BatchNorm statistics on 4 seeded chunks.
- ``t_flagship.npz`` and ``t_flagship_arch.json``: the T_flagship checkpoint
  (``evidence/r5/T_flagship/ckpt_best``) and its sidecar, flattened the same
  way: the port's second set of trained weights.
- ``robust_golden.npz``: the JAX package's fp32 ``evaluate_robustness`` on the
  8 golden chunks: its table for the ten deterministic attacks, and per clip
  what it read from ``detect_summary`` (``p_wm``, ``p_clean``,
  ``msg_logit_mean``).
- ``robust_train_golden.npz``: one fp32 JAX train step under the C_robust
  attack curriculum, with every attack draw stored (read off the key splits),
  the terms, gradient norms and BatchNorm statistics.
- ``strided_golden.npz``: the strided preset (main14b_2) at full width with
  weights drawn by ``awm_tpu_torch.checkpoint.seeded_flax_tree`` from the
  stored ``seed`` (the weights themselves, 8.9 M floats, are not stored):
  the JAX package's fp32 ``embed_chunks`` deltas and ``embed_detect``
  summaries on the 8 golden chunks, and one fp32 train step's loss terms and
  gradient norms on the 4 train-golden chunks (``train/chunks``,
  ``train/messages``, ``term/*``, ``grad_norm/*``; the family has no
  BatchNorm).

``tests/test_torch_checkpoint.py`` regenerates them and asserts that they
equal the committed files.  To rewrite them:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_assets.py
"""

from __future__ import annotations

import dataclasses
import os
import shutil

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "evidence", "r5", "shapecap", "ckpt_best")
ASSETS = os.path.join(REPO, "awm_tpu_torch", "assets")
WEIGHTS_NPZ = os.path.join(ASSETS, "shapecap.npz")
GOLDEN_NPZ = os.path.join(ASSETS, "shapecap_golden.npz")
ARCH_JSON = os.path.join(ASSETS, "awm_arch.json")

TRAIN_GOLDEN_NPZ = os.path.join(ASSETS, "train_golden.npz")
FLAGSHIP_CKPT = os.path.join(REPO, "evidence", "r5", "T_flagship", "ckpt_best")
FLAGSHIP_NPZ = os.path.join(ASSETS, "t_flagship.npz")
FLAGSHIP_ARCH = os.path.join(ASSETS, "t_flagship_arch.json")
ROBUST_GOLDEN_NPZ = os.path.join(ASSETS, "robust_golden.npz")
ROBUST_TRAIN_GOLDEN_NPZ = os.path.join(ASSETS, "robust_train_golden.npz")
STRIDED_GOLDEN_NPZ = os.path.join(ASSETS, "strided_golden.npz")

GOLDEN_SEED = 20261016
GOLDEN_CHUNKS = 8
TRAIN_SEED = 20261017
TRAIN_CHUNKS = 4
ROBUST_TRAIN_SEED = 3  # rng seed of the robust golden step
STRIDED_SEED = 20261018  # seeded_flax_tree seed of the strided golden's weights
# the C_robust leg's curriculum (awm_tpu/__main__.py:352-354 through :258-267)
ROBUST_AUGMENT = dict(noise_snr_db=(10.0, 40.0), volume_range=(0.3, 1.2),
                      lowpass_hz=(3500.0, 5000.0, 7000.0), quantize=True,
                      resample_hz=(8000, 11025, 22050), attack_prob=0.45)
STOCHASTIC_ATTACKS = ("noise_30db", "noise_20db")


def flatten(tree, prefix=()):
    """Nested dict of arrays -> {'a/b/c': np.ndarray}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def shapecap_config(ckpt=CKPT):
    """The JAX Config that a checkpoint (shapecap by default) was trained
    with, from its arch sidecar."""
    from awm_tpu import checkpoint as ck
    from awm_tpu.config import ModelConfig, ShapingConfig, get_config

    arch = ck.read_arch(ckpt)
    cfg = get_config("base")
    if "shaping" in arch:
        cfg = dataclasses.replace(cfg, shaping=ShapingConfig(**arch.pop("shaping")))
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    arch = {k: v for k, v in arch.items() if k in known}
    arch["strides"] = tuple(arch["strides"])
    return dataclasses.replace(cfg, model=ModelConfig(**arch))


def restore_shapecap(ckpt=CKPT):
    """(cfg, state, gen, det) with a checkpoint's weights (shapecap by
    default) restored from orbax."""
    import jax

    from awm_tpu import checkpoint as ck
    from awm_tpu import train as tr

    cfg = shapecap_config(ckpt)
    state, gen, det = tr.init_state(cfg, jax.random.key(0))
    state, _, _ = ck.restore_params(ckpt, state)
    return cfg, state, gen, det


def weights_arrays(state):
    return flatten({"params": state.params, "batch_stats": state.batch_stats})


def golden_inputs(seed=GOLDEN_SEED, n=GOLDEN_CHUNKS):
    """n speech-like 1-s chunks and 16-bit messages from a fixed seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(16000) / 16000.0
    chunks = []
    for _ in range(n):
        f0 = rng.uniform(90.0, 260.0)
        x = sum(
            rng.uniform(0.05, 0.3) / k * np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6.3))
            for k in range(1, 9)
        )
        env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t)
        chunks.append(x * env + 0.01 * rng.standard_normal(16000))
    messages = rng.integers(0, 2**16, size=n)
    return np.stack(chunks).astype(np.float32), messages.astype(np.int32)


def golden_arrays(cfg, state, gen, det):
    """JAX fp32 serving outputs on golden_inputs()."""
    import jax.numpy as jnp

    from awm_tpu.api import InferenceSession

    sess = InferenceSession.from_state(cfg, gen, det, state, compute_dtype=jnp.float32)
    chunks, messages = golden_inputs()
    out = {"chunks": chunks, "messages": messages}
    out["embed_delta"] = np.asarray(sess.embed_chunks(chunks, messages), np.float32)
    summary = sess.embed_detect(chunks, messages)
    out.update({k: np.asarray(v, np.float32) for k, v in summary.items()})
    return out


def train_config(audio_len=16000, compute_dtype="float32"):
    """The JAX Config of the port's train path: the shapecap architecture and
    shaping, the base preset's losses with --dec-loss mean, fp32 unless
    asked otherwise."""
    cfg = shapecap_config()
    return dataclasses.replace(
        cfg, audio_len=audio_len,
        loss=dataclasses.replace(cfg.loss, dec_loss_mode="mean"),
        train=dataclasses.replace(cfg.train, compute_dtype=compute_dtype),
    )


def unflatten(flat):
    """{'a/b/c': array} -> nested dict of jnp arrays."""
    import jax.numpy as jnp

    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def jax_state_from_npz(cfg, npz=WEIGHTS_NPZ):
    """(state, gen, det, tx) of the JAX package with the weights of a
    flattened .npz and a fresh optimizer."""
    import jax

    from awm_tpu import train as tr

    state, gen, det = tr.init_state(cfg, jax.random.key(0))
    with np.load(npz) as f:
        tree = unflatten({k: f[k] for k in f.files})
    tx = tr.make_optimizer(cfg)
    state = state.replace(params=tree["params"], batch_stats=tree["batch_stats"],
                          opt_state=tx.init(tree["params"]))
    return state, gen, det, tx


def jax_message(cfg, state, b, seed):
    """The messages awm_tpu.train.train_step draws for this step and rng
    seed (train.py:182-185)."""
    import jax
    import jax.numpy as jnp

    step_key = jax.random.fold_in(jax.random.key(seed), state.step)
    msg_key, _ = jax.random.split(step_key)
    return jax.random.randint(msg_key, (b,), 0, 2**cfg.message_bits, dtype=jnp.int32)


def jax_loss_and_grads(cfg, gen, det, state, s, message, aug_key=None):
    """train_step's loss function (awm_tpu/train.py:187-205) for a given
    message (and attack key): (terms, grads, post-step batch_stats)."""
    import jax

    from awm_tpu import train as tr
    from awm_tpu.losses import total_loss

    def loss_fn(params):
        delta, s_w, logits, new_bs = tr._forward(
            cfg, gen, det, params, state.batch_stats, s, message, train=True, aug_key=aug_key
        )
        terms = total_loss(cfg.loss, s=s, s_w=s_w, delta=delta, logits=logits,
                           message=message, message_bits=cfg.message_bits)
        return terms["total"], (terms, new_bs)

    (_, (terms, new_bs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params)
    return terms, grads, new_bs


def jax_augment_draws(key, cfg, batch, length):
    """What awm_tpu.augment.apply_augment(x, key, cfg) draws for a (batch,
    length) input, read off its key splits (augment.py:118-171, add_noise
    :71-76, random_volume :86), as numpy arrays under the names of the
    port's augment.draw_augment."""
    import jax

    draws = {}

    def mask(name, k):
        if cfg.attack_prob < 1.0:
            draws[f"{name}_mask"] = np.asarray(jax.random.bernoulli(k, cfg.attack_prob, (batch, 1)))

    def choice(name, k, options):
        options = tuple(options) if isinstance(options, (tuple, list)) else (options,)
        if len(options) > 1:
            draws[f"{name}_choice"] = np.asarray(
                jax.random.randint(k, (batch, 1), 0, len(options))).astype(np.int64)

    if cfg.noise_snr_db is not None:
        key, k1, k2 = jax.random.split(key, 3)
        mask("noise", k1)
        ka, kb = jax.random.split(k2)
        draws["noise_snr_db"] = np.asarray(jax.random.uniform(
            ka, (batch, 1), minval=cfg.noise_snr_db[0], maxval=cfg.noise_snr_db[1]))
        draws["noise"] = np.asarray(jax.random.normal(kb, (batch, length), np.float32))
    if cfg.volume_range is not None:
        key, k1, k2 = jax.random.split(key, 3)
        mask("volume", k1)
        draws["volume_gain"] = np.asarray(jax.random.uniform(
            k2, (batch, 1), minval=cfg.volume_range[0], maxval=cfg.volume_range[1]))
    if cfg.resample_hz is not None:
        key, k1, k2 = jax.random.split(key, 3)
        mask("resample", k1)
        choice("resample", k2, cfg.resample_hz)
    if cfg.lowpass_hz is not None:
        key, k1, k2 = jax.random.split(key, 3)
        mask("lowpass", k1)
        choice("lowpass", k2, cfg.lowpass_hz)
    if cfg.quantize:
        key, k1 = jax.random.split(key)
        mask("quantize", k1)
    if cfg.mulaw:
        key, k1 = jax.random.split(key)
        mask("mulaw", k1)
    return draws


def jax_step_aug_key(state, seed):
    """The attack key awm_tpu.train.train_step derives for this step and rng
    seed (train.py:183-184)."""
    import jax

    return jax.random.split(jax.random.fold_in(jax.random.key(seed), state.step))[1]


def torch_named(tree):
    """A JAX {'gen': ..., 'det': ...} subtree of params (or grads) and/or
    batch_stats -> {'gen.<torch name>': np.ndarray} in the port's layout."""
    from awm_tpu_torch.checkpoint import variables_from_flax

    out = {}
    for net in ("gen", "det"):
        sub = {part: jax_to_np(tree[part][net]) for part in ("params", "batch_stats") if part in tree}
        out.update({f"{net}.{k}": v.numpy() for k, v in variables_from_flax(sub).items()})
    return out


def port_names(tree, part, path):
    """The port's names of the leaves under `path` (a list of keys, a module
    or one of its leaves) in part ('params' or 'batch_stats') of one
    network's JAX tree of numpy arrays: what restore_params lists as kept at
    init, in the port's dotted form."""
    from awm_tpu_torch.checkpoint import variables_from_flax

    node = tree
    for k in path:
        node = node[k]
    sub = node
    for k in reversed(path):
        sub = {k: sub}
    return sorted(variables_from_flax({part: sub}))


def jax_to_np(tree):
    return {k: jax_to_np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def train_golden_arrays():
    """One fp32 JAX train step on train_golden_inputs: terms, per-parameter
    gradient norms and the post-step BatchNorm statistics."""
    import jax.numpy as jnp

    cfg = train_config()
    state, gen, det, _ = jax_state_from_npz(cfg)
    chunks, messages = golden_inputs(TRAIN_SEED, TRAIN_CHUNKS)
    terms, grads, new_bs = jax_loss_and_grads(
        cfg, gen, det, state, jnp.asarray(chunks), jnp.asarray(messages)
    )
    out = {"chunks": chunks, "messages": messages}
    out.update({f"term/{k}": np.asarray(v, np.float32) for k, v in terms.items()})
    out.update({f"grad_norm/{k}": np.asarray(np.linalg.norm(v), np.float32)
                for k, v in torch_named({"params": grads}).items()})
    out.update({f"batch_stats/{k}": v for k, v in torch_named({"batch_stats": new_bs}).items()})
    return out


class _RecordingSession:
    """A session that also keeps what detect_summary returned, call by call."""

    def __init__(self, session):
        self._session = session
        self.summaries = []

    def __getattr__(self, name):
        return getattr(self._session, name)

    def detect_summary(self, chunks, lengths=None):
        out = self._session.detect_summary(chunks, lengths)
        self.summaries.append(out)
        return out


def robust_golden_arrays(cfg, state, gen, det):
    """awm_tpu.eval.evaluate_robustness (fp32 session, seed 0) on
    golden_inputs()'s chunks: "table/<attack>/<column>" for the deterministic
    attacks, and per clip what the sweep read from the detector for each:
    "p_wm/<attack>", "p_clean/<attack>" (N,) and "mlm/<attack>" (N, 16)."""
    import jax.numpy as jnp

    from awm_tpu.api import InferenceSession
    from awm_tpu.eval import evaluate_robustness

    sess = _RecordingSession(
        InferenceSession.from_state(cfg, gen, det, state, compute_dtype=jnp.float32))
    chunks, _ = golden_inputs()
    table = evaluate_robustness(sess, chunks, seed=0)
    out = {}
    for i, name in enumerate(table):
        if name in STOCHASTIC_ATTACKS:
            continue
        (_, mlm_wm, _, p_wm), (_, _, _, p_clean) = sess.summaries[2 * i], sess.summaries[2 * i + 1]
        out[f"p_wm/{name}"] = np.asarray(p_wm, np.float32)
        out[f"p_clean/{name}"] = np.asarray(p_clean, np.float32)
        out[f"mlm/{name}"] = np.asarray(mlm_wm, np.float32)
        out.update({f"table/{name}/{col}": np.float64(v) for col, v in table[name].items()})
    return out


def robust_train_config(audio_len=16000):
    """train_config() with the C_robust attack curriculum."""
    from awm_tpu.augment import AugmentConfig

    return dataclasses.replace(train_config(audio_len), augment=AugmentConfig(**ROBUST_AUGMENT))


def robust_train_golden_arrays():
    """One fp32 JAX train step under ROBUST_AUGMENT on the train golden's
    chunks, as awm_tpu.train.train_step runs it under rng seed
    ROBUST_TRAIN_SEED: the message and every attack draw it takes
    ("draw/<name>"), the terms, per-parameter gradient norms and the
    post-step BatchNorm statistics."""
    import jax.numpy as jnp

    cfg = robust_train_config()
    state, gen, det, _ = jax_state_from_npz(cfg)
    chunks, _ = golden_inputs(TRAIN_SEED, TRAIN_CHUNKS)
    b, t = chunks.shape
    messages = np.asarray(jax_message(cfg, state, b, ROBUST_TRAIN_SEED))
    aug_key = jax_step_aug_key(state, ROBUST_TRAIN_SEED)
    terms, grads, new_bs = jax_loss_and_grads(
        cfg, gen, det, state, jnp.asarray(chunks), jnp.asarray(messages), aug_key
    )
    out = {"chunks": chunks, "messages": messages}
    out.update({f"draw/{k}": v for k, v in jax_augment_draws(aug_key, cfg.augment, 2 * b, t).items()})
    out.update({f"term/{k}": np.asarray(v, np.float32) for k, v in terms.items()})
    out.update({f"grad_norm/{k}": np.asarray(np.linalg.norm(v), np.float32)
                for k, v in torch_named({"params": grads}).items()})
    out.update({f"batch_stats/{k}": v for k, v in torch_named({"batch_stats": new_bs}).items()})
    return out


def strided_state(cfg, seed=STRIDED_SEED):
    """(state, gen, det) of the JAX package for a strided Config, with the
    weights seeded_flax_tree draws for it from `seed`."""
    import jax
    import jax.numpy as jnp

    from awm_tpu import train as tr
    from awm_tpu_torch.checkpoint import seeded_flax_tree
    from awm_tpu_torch.config import ModelConfig as PortModelConfig

    fields = {f.name for f in dataclasses.fields(PortModelConfig)}
    port_model = PortModelConfig(**{k: v for k, v in dataclasses.asdict(cfg.model).items()
                                    if k in fields})
    tree = seeded_flax_tree(port_model, seed)
    state, gen, det = tr.init_state(cfg, jax.random.key(0))
    params = jax.tree.map(jnp.asarray, tree["params"])
    return state.replace(params=params, opt_state=tr.make_optimizer(cfg).init(params)), gen, det


def strided_golden_arrays():
    """The JAX package's fp32 strided session on golden_inputs() and one fp32
    strided train step on the train golden's chunks, weights from
    STRIDED_SEED."""
    import jax.numpy as jnp

    from awm_tpu.api import InferenceSession
    from awm_tpu.config import get_config

    cfg = get_config("strided")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    state, gen, det = strided_state(cfg)
    sess = InferenceSession.from_state(cfg, gen, det, state, compute_dtype=jnp.float32)
    chunks, messages = golden_inputs()
    out = {"seed": np.int64(STRIDED_SEED), "chunks": chunks, "messages": messages,
           "embed_delta": np.asarray(sess.embed_chunks(chunks, messages), np.float32)}
    out.update({k: np.asarray(v, np.float32) for k, v in sess.embed_detect(chunks, messages).items()})
    chunks, messages = golden_inputs(TRAIN_SEED, TRAIN_CHUNKS)
    terms, grads, _ = jax_loss_and_grads(cfg, gen, det, state, jnp.asarray(chunks), jnp.asarray(messages))
    out.update({"train/chunks": chunks, "train/messages": messages})
    out.update({f"term/{k}": np.asarray(v, np.float32) for k, v in terms.items()})
    out.update({f"grad_norm/{k}": np.asarray(np.linalg.norm(v), np.float32)
                for k, v in torch_named({"params": grads}).items()})
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    cfg, state, gen, det = restore_shapecap()
    os.makedirs(ASSETS, exist_ok=True)
    np.savez(WEIGHTS_NPZ, **weights_arrays(state))
    np.savez(GOLDEN_NPZ, **golden_arrays(cfg, state, gen, det))
    shutil.copyfile(os.path.join(CKPT, "awm_arch.json"), ARCH_JSON)
    np.savez(TRAIN_GOLDEN_NPZ, **train_golden_arrays())
    np.savez(ROBUST_GOLDEN_NPZ, **robust_golden_arrays(cfg, state, gen, det))
    np.savez(ROBUST_TRAIN_GOLDEN_NPZ, **robust_train_golden_arrays())
    np.savez(FLAGSHIP_NPZ, **weights_arrays(restore_shapecap(FLAGSHIP_CKPT)[1]))
    shutil.copyfile(os.path.join(FLAGSHIP_CKPT, "awm_arch.json"), FLAGSHIP_ARCH)
    np.savez(STRIDED_GOLDEN_NPZ, **strided_golden_arrays())
    print("wrote", WEIGHTS_NPZ, GOLDEN_NPZ, ARCH_JSON, TRAIN_GOLDEN_NPZ, ROBUST_GOLDEN_NPZ,
          ROBUST_TRAIN_GOLDEN_NPZ, FLAGSHIP_NPZ, FLAGSHIP_ARCH, STRIDED_GOLDEN_NPZ)


if __name__ == "__main__":
    main()
