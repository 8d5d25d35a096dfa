"""Checkpoints, weights and architecture for the port (counterpart of
awm_tpu/checkpoint.py).

A checkpoint of the port is a directory holding ``torch_state.pt`` (both
networks' fp32 parameters and BatchNorm statistics, the Adam state, step,
epoch and best_val; ``torch.load(..., weights_only=True)`` reads it) and
``awm_arch.json``, written with the keys of the JAX package's sidecar so
that each package's ``read_arch`` parses the other's.  ``fit`` writes
``ckpt_latest`` every epoch and ``ckpt_best`` on improvement, and resumes
from ``ckpt_latest`` (``maybe_resume``).  The step's random draws derive from
(seed, step) (train.py), so a checkpoint holds no random state.

The port reads no orbax tree.  A JAX checkpoint crosses over once as an
``.npz`` of its ``{'params', 'batch_stats'}`` tree flattened to ``/``-joined
keys (``params/gen/enc_conv/w``); ``assets/shapecap.npz`` is the committed
shapecap checkpoint (evidence/r5/shapecap/ckpt_best), and
``assets/awm_arch.json`` its architecture sidecar; ``assets/t_flagship.npz``
and ``assets/t_flagship_arch.json`` are evidence/r5/T_flagship/ckpt_best, the
same architecture trained without the shaping chain.  ``variables_from_flax``
maps one network's tree of either family onto the port's ``state_dict``: the
inverse of the JAX importer's ``_conv`` / ``_conv_t`` / ``_bn`` / LSTM /
``proj`` layouts (awm_tpu/checkpoint.py:289-416).  ``restore_params`` reads
either source.  ``seeded_flax_tree`` draws such a tree for any ModelConfig
from a seed: the strided family's parity assets hold a seed, not 33 MB of
weights.

The reference's torch ``.pth`` state dicts map onto the port's modules
through ``import_torch_generator`` / ``import_torch_detector`` (base family)
and ``import_torch_strided_generator`` / ``import_torch_strided_detector``
(main14b_2).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from awm_tpu_torch.config import ModelConfig, ShapingConfig

ARCH_FILE = "awm_arch.json"
STATE_FILE = "torch_state.pt"
ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
SHAPECAP_NPZ = os.path.join(ASSETS, "shapecap.npz")
SHAPECAP_ARCH = os.path.join(ASSETS, ARCH_FILE)
T_FLAGSHIP_NPZ = os.path.join(ASSETS, "t_flagship.npz")
T_FLAGSHIP_ARCH = os.path.join(ASSETS, "t_flagship_arch.json")

# flax modules that are ConvTranspose1d (their (k, in, out) weight becomes
# torch's (in, out, k), without a flip): the base generator's dec_deconv and
# the strided upsamplers dec_up{i} / up{i}.  Every other 3-axis 'w' is a
# Conv1d, and a 2-axis 'w' the strided proj Linear's (in, out).
_TRANSPOSED = re.compile(r"dec_deconv|(dec_)?up\d+")
# The JAX ModelConfig's fields in its order.  lstm_impl is not modelled (the
# port routes the LSTM by device) and is written at the JAX default.
_ARCH_KEYS = ("family", "message_bits", "lstm_impl", "channels", "message_encoding",
              "decode_head", "delta_band_hz", "base_channels", "hidden_dim",
              "output_channels", "strides", "lstm_layers")
_JAX_ONLY_DEFAULTS = {"lstm_impl": "auto"}
_ORBAX_FILES = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


# -- architecture sidecar ---------------------------------------------------


def _write_atomic(path: str, write) -> None:
    """write(tmp) then rename over path: a reader never sees half a file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


def write_arch(path: str, model_cfg, shaping_cfg=None) -> None:
    """Record the architecture in a checkpoint directory, with the keys of
    the JAX package's write_arch, and the shaping chain when it is enabled."""
    doc = {k: getattr(model_cfg, k) if hasattr(model_cfg, k) else _JAX_ONLY_DEFAULTS[k]
           for k in _ARCH_KEYS}
    if shaping_cfg is not None and shaping_cfg.enabled:
        doc["shaping"] = dataclasses.asdict(shaping_cfg)

    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)

    _write_atomic(os.path.join(path, ARCH_FILE), write)


def read_arch(path: str) -> Optional[dict]:
    """The recorded architecture dict of a checkpoint directory (its
    awm_arch.json) or of a .json file; None where a directory has none."""
    p = path if path.endswith(".json") else os.path.join(path, ARCH_FILE)
    if not os.path.exists(p):
        if path.endswith(".json"):
            raise FileNotFoundError(p)
        return None
    with open(p) as f:
        return json.load(f)


def configs_from_arch(arch: Optional[dict]) -> Tuple[ModelConfig, Optional[ShapingConfig]]:
    """(ModelConfig, ShapingConfig or None) from an arch dict; fields the
    port does not read (lstm_impl) are dropped, strides become a tuple."""
    arch = dict(arch or {})
    shaping = arch.pop("shaping", None)
    if "strides" in arch:
        arch["strides"] = tuple(arch["strides"])
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    model = ModelConfig(**{k: v for k, v in arch.items() if k in known})
    if shaping is None:
        return model, None
    sknown = {f.name for f in dataclasses.fields(ShapingConfig)}
    return model, ShapingConfig(**{k: v for k, v in shaping.items() if k in sknown})


# -- the flax -> torch bridge -------------------------------------------------


def load_npz(path: str) -> Dict[str, Any]:
    """A flattened .npz -> the nested tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def _module_leaves(name: str, node: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One flax module's leaves -> {torch name: array in torch layout}."""
    keys = set(node)
    if "w" in keys and keys <= {"w", "b"}:  # Conv1d / ConvTranspose1d / Linear
        if node["w"].ndim == 2:
            perm = (1, 0)
        else:
            perm = (1, 2, 0) if _TRANSPOSED.fullmatch(name) else (2, 1, 0)
        out = {"weight": np.transpose(node["w"], perm)}
        if "b" in node:
            out["bias"] = node["b"]
        return out
    if keys == {"scale", "bias"}:  # BatchNorm params
        return {"weight": node["scale"], "bias": node["bias"]}
    if keys == {"mean", "var"}:  # BatchNorm batch_stats
        return {"running_mean": node["mean"], "running_var": node["var"]}
    if keys == {"w_ih", "w_hh", "b"}:  # LSTM: torch layout already
        return dict(node)
    if keys == {"table"}:  # Embedding
        return {"weight": node["table"]}
    if keys == {"kernel"}:  # Dense without bias -> nn.Linear
        return {"weight": np.transpose(node["kernel"])}
    raise ValueError(f"unrecognised flax module {name!r} with leaves {sorted(keys)}")


def _walk(node: Dict[str, Any], prefix: Tuple[str, ...], out: Dict[str, torch.Tensor]) -> None:
    if all(isinstance(v, np.ndarray) for v in node.values()):
        name = prefix[-1] if prefix else ""
        for k, v in _module_leaves(name, node).items():
            out[".".join(prefix + (k,))] = torch.from_numpy(np.array(v, np.float32))
        return
    for k, v in node.items():
        _walk(v, prefix + (k,), out)


def variables_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """One network's {'params', 'batch_stats'} tree of numpy arrays -> the
    port's state_dict (fp32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for part in ("params", "batch_stats"):
        if tree.get(part):
            _walk(tree[part], (), out)
    return out


def seeded_flax_tree(model_cfg, seed: int) -> Dict[str, Any]:
    """{'params': {'gen', 'det'}, 'batch_stats': {'gen', 'det'}} of fp32
    numpy arrays in the JAX package's layout for the networks of a
    ModelConfig, drawn with numpy's generator at `seed` in the initialisers'
    distributions (awm_tpu/models/layers.py): U(+-1/sqrt(fan_in)) for conv,
    ConvTranspose and Linear weights and biases, U(+-1/sqrt(H)) for the LSTM
    weights and the sum of two such draws for its one bias, N(0, 1) for the
    message table, N(0, 0.25) for the bits encoder, BatchNorm at (1, 0) with
    statistics (0, 1).  The same seed gives the same tree on any machine, with
    or without JAX; variables_from_flax takes it to the port's networks."""
    from awm_tpu_torch.models import build_models
    from awm_tpu_torch.models.layers import BatchNorm, Conv1d, ConvTranspose1d, Embedding, LSTM
    from awm_tpu_torch.models.strided import Linear

    rng = np.random.default_rng(seed)

    def u(fan_in, *shape):
        bound = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for net_name, net in zip(("gen", "det"), build_models(model_cfg)):
        for name, m in net.named_modules():
            params, stats = {}, {}
            if isinstance(m, Conv1d):
                out, cin, k = m.weight.shape
                params["w"] = u(cin * k, k, cin, out)
                if m.bias is not None:
                    params["b"] = u(cin * k, out)
            elif isinstance(m, ConvTranspose1d):
                cin, out, k = m.weight.shape
                params = {"w": u(out * k, k, cin, out), "b": u(out * k, out)}
            elif isinstance(m, Linear):
                out, cin = m.weight.shape
                params = {"w": u(cin, cin, out), "b": u(cin, out)}
            elif isinstance(m, LSTM):
                g, d = m.w_ih.shape
                h = g // 4
                params = {"w_ih": u(h, g, d), "w_hh": u(h, g, h), "b": u(h, g) + u(h, g)}
            elif isinstance(m, Embedding):
                params = {"table": rng.standard_normal(tuple(m.weight.shape)).astype(np.float32)}
            elif isinstance(m, BatchNorm):
                ch = m.weight.shape[0]
                params = {"scale": np.ones(ch, np.float32), "bias": np.zeros(ch, np.float32)}
                stats = {"mean": np.zeros(ch, np.float32), "var": np.ones(ch, np.float32)}
            elif isinstance(m, torch.nn.Linear):  # the bits encoder, flax Dense without bias
                out, cin = m.weight.shape
                params = {"kernel": (0.25 * rng.standard_normal((cin, out))).astype(np.float32)}
            for part, leaves in (("params", params), ("batch_stats", stats)):
                if leaves:
                    node = tree[part].setdefault(net_name, {})
                    for key in name.split("."):
                        node = node.setdefault(key, {})
                    node.update(leaves)
    return tree


def load_models(params_npz: str = SHAPECAP_NPZ, arch_json: str = SHAPECAP_ARCH):
    """(generator, detector, ModelConfig, ShapingConfig or None) with the
    weights of a flattened .npz, fp32 on the CPU, in eval mode."""
    from awm_tpu_torch.models import build_models

    model_cfg, shaping = configs_from_arch(read_arch(arch_json))
    gen, det = build_models(model_cfg)
    restore_params(params_npz, gen, det)
    gen.eval()
    det.eval()
    return gen, det, model_cfg, shaping


# -- checkpoints ----------------------------------------------------------------


def latest_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "ckpt_latest")


def best_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "ckpt_best")


def is_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, STATE_FILE))


def save_checkpoint(path: str, state, *, epoch: int = 0, best_val: float = float("inf"),
                    model_cfg=None, shaping_cfg=None) -> None:
    """Write a TrainState (train.py) with epoch and best_val to the directory
    path, overwriting it.  The arch sidecar goes first and the state file is
    renamed into place last, so an interrupted save leaves the previous
    checkpoint (or none) and never half of one.  A state on a mesh is saved
    whole (its message table gathered over the model group, so every rank
    calls this) by rank 0 alone, and restores on any layout."""
    from awm_tpu_torch.parallel.mesh import full_state_dicts, is_lead

    state_dicts = full_state_dicts(state)
    if not is_lead(state.mesh):
        return
    os.makedirs(path, exist_ok=True)
    if model_cfg is not None:
        write_arch(path, model_cfg, shaping_cfg)
    payload = {
        **state_dicts,
        "step": int(state.step),
        "epoch": int(epoch),
        "best_val": float(best_val),
    }
    _write_atomic(os.path.join(path, STATE_FILE), lambda tmp: torch.save(payload, tmp))


def _payload(path: str, map_location="cpu") -> Dict[str, Any]:
    if not is_checkpoint(path):
        if any(os.path.exists(os.path.join(path, f)) for f in _ORBAX_FILES):
            raise ValueError(
                f"{path} is an orbax checkpoint of the JAX package; the port reads no orbax "
                "tree.  Flatten its {'params', 'batch_stats'} once to an .npz with the JAX "
                "package, as tests/torch_assets.py does for assets/shapecap.npz "
                "(restore_shapecap + weights_arrays + np.savez), and pass that .npz with its "
                "awm_arch.json")
        raise FileNotFoundError(f"no checkpoint of the port at {path!r} ({STATE_FILE} missing)")
    return torch.load(os.path.join(path, STATE_FILE), map_location=map_location, weights_only=True)


def restore_checkpoint(path: str, state) -> Tuple[Any, int, float]:
    """Restore a TrainState in place from a checkpoint directory, onto the
    state's own device (a checkpoint written on the card restores on the
    CPU).  A sharded state cannot take a whole checkpoint: restore first,
    then parallel.shard_state.  Returns (state, epoch, best_val)."""
    if state.mesh is not None:
        raise ValueError("restore a checkpoint before parallel.shard_state, not into a sharded state")
    payload = _payload(path, map_location=next(state.gen.parameters()).device)
    state.gen.load_state_dict(payload["gen"])
    state.det.load_state_dict(payload["det"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = payload["step"]
    return state, payload["epoch"], payload["best_val"]


def maybe_resume(ckpt_dir: str, state):
    """Resume from ckpt_latest when it exists.  Returns (state, epoch,
    best_val, resumed)."""
    p = latest_path(ckpt_dir)
    if is_checkpoint(p):
        state, epoch, best_val = restore_checkpoint(p, state)
        return state, epoch, best_val, True
    return state, 0, float("inf"), False


def _source_weights(path: str) -> Tuple[Dict[str, Dict[str, torch.Tensor]], int, float]:
    """({'gen': state_dict, 'det': state_dict}, epoch, best_val) of a
    flattened .npz (epoch 0, best_val 0.0) or a checkpoint directory."""
    if os.path.isdir(path):
        payload = _payload(path)
        return {n: payload[n] for n in ("gen", "det")}, payload["epoch"], payload["best_val"]
    nets = load_npz(path)
    return ({n: variables_from_flax({p: nets.get(p, {}).get(n, {}) for p in ("params", "batch_stats")})
             for n in ("gen", "det")}, 0, 0.0)


def restore_params(path: str, gen, det, allow_missing: bool = False) -> Tuple[List[str], int, float]:
    """Copy only the weights and BatchNorm statistics of a checkpoint
    directory or a flattened .npz into existing networks (ignoring any
    optimizer state), with the JAX package's rules (awm_tpu/checkpoint.py:
    126-248): a leaf of the source that the networks lack is ignored, and a
    leaf whose shape differs counts as absent.  allow_missing=True lets
    absent leaves keep their initial values (a cross-architecture
    warm-start, e.g. a new message encoder or decode head) and prints them;
    without it any absent leaf raises.  A source that shares no parameter
    with the networks raises either way (a wrong path or another family).
    Returns (the names left at their initial values, epoch, best_val)."""
    sources, epoch, best_val = _source_weights(path)
    kept, notes, shared, takes = [], [], 0, []
    for name, net in (("gen", gen), ("det", det)):
        src, params, take = sources[name], dict(net.named_parameters()), {}
        for k, v in net.state_dict().items():
            have = src.get(k)
            if have is None:
                notes.append(f"{name}.{k}")
            elif tuple(have.shape) != tuple(v.shape):
                notes.append(f"{name}.{k} (shape {tuple(v.shape)} != on-disk {tuple(have.shape)})")
            else:
                take[k] = have
                shared += k in params
                continue
            kept.append(f"{name}.{k}")
        takes.append((net, take))
    if shared == 0:
        raise ValueError(
            f"checkpoint {path} shares no parameter leaves with the networks (wrong path, or "
            f"a different model family?); {len(kept)} leaves absent, e.g. {', '.join(notes[:5])}")
    if kept and not allow_missing:
        raise ValueError(
            f"{len(kept)} leaves absent from checkpoint {path}: {', '.join(notes[:8])}"
            f"{'...' if len(notes) > 8 else ''} (pass allow_missing=True to warm-start them from init)")
    for net, take in takes:
        net.load_state_dict(take, strict=False)
    if kept:
        print(f"restore_params: kept init for {len(kept)} leaves absent from {path}: "
              f"{', '.join(notes[:8])}")
    return kept, epoch, best_val


def load_into(gen, det, path: str) -> List[str]:
    """restore_params with allow_missing (a fine-tune's start): the names
    left at their initial values."""
    return restore_params(path, gen, det, allow_missing=True)[0]


# -- the reference's torch .pth ------------------------------------------------


def strip_prefix(state_dict: Dict[str, Any], prefix: str = "_orig_mod.") -> Dict[str, Any]:
    """Remove the torch.compile wrapper prefix (ref: py/main14.py:593-598)."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in state_dict.items()}


def _load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    return strip_prefix(torch.load(path, map_location="cpu", weights_only=True))


def _renamed(sd: Dict[str, torch.Tensor], modules: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """{port module: reference module} -> the port's state_dict, fp32 (BN's
    num_batches_tracked dropped; the port does not keep it)."""
    out = {}
    for dst, src in modules.items():
        for k, v in sd.items():
            leaf = k[len(src) + 1:]
            if k.startswith(src + ".") and "." not in leaf and leaf != "num_batches_tracked":
                out[f"{dst}.{leaf}"] = v.detach().to(torch.float32).clone()
    return out


def _resblock(dst: str, src: str) -> Dict[str, str]:
    """Reference ResBlock: block.0 conv, block.1 bn, block.3 conv, block.4 bn
    (ref: py/main14.py:74-87)."""
    return {f"{dst}.conv1": f"{src}.block.0", f"{dst}.bn1": f"{src}.block.1",
            f"{dst}.conv2": f"{src}.block.3", f"{dst}.bn2": f"{src}.block.4"}


def import_torch_detector(path: str) -> Dict[str, torch.Tensor]:
    """models/detector_best.pth -> the state_dict of a shared-head
    models.Detector (torch layout: model.0 conv-in, model.1/2 ResBlocks,
    model.3 conv-out; ref: py/main14.py:132-148)."""
    sd = _load_torch_state_dict(path)
    return _renamed(sd, {"conv_in": "model.0", **_resblock("res1", "model.1"),
                         **_resblock("res2", "model.2"), "conv_out": "model.3"})


def import_torch_generator(path: str) -> Dict[str, torch.Tensor]:
    """generator_best.pth -> the state_dict of a table-encoder
    models.Generator (torch layout: encoder.0 conv, encoder.1/2 ResBlocks,
    lstm, embedding, decoder.0 ConvTranspose, decoder.1 ResBlock, decoder.2
    conv; ref: py/main14.py:90-124).  The LSTM's two biases are summed: they
    only ever appear added."""
    sd = _load_torch_state_dict(path)
    out = _renamed(sd, {"enc_conv": "encoder.0", **_resblock("enc_res1", "encoder.1"),
                        **_resblock("enc_res2", "encoder.2"), "embedding": "embedding",
                        "dec_deconv": "decoder.0", **_resblock("dec_res", "decoder.1"),
                        "dec_out": "decoder.2"})
    out["lstm.w_ih"] = sd["lstm.weight_ih_l0"].detach().float().clone()
    out["lstm.w_hh"] = sd["lstm.weight_hh_l0"].detach().float().clone()
    out["lstm.b"] = (sd["lstm.bias_ih_l0"] + sd["lstm.bias_hh_l0"]).detach().float()
    return out


def _strided_resblock(dst: str, src: str, sd: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """main14b_2 ResidualBlock: conv1, conv2 and, where the block changes
    the shape, skip_conv (ref: py/main14b_2.py:86-103)."""
    out = {f"{dst}.conv1": f"{src}.conv1", f"{dst}.conv2": f"{src}.conv2"}
    if f"{src}.skip_conv.weight" in sd:
        out[f"{dst}.skip"] = f"{src}.skip_conv"
    return out


def _lstm_layers(sd: Dict[str, torch.Tensor], key: str) -> Dict[str, torch.Tensor]:
    """torch nn.LSTM(num_layers=N) -> lstm0..lstm{N-1} of the port, each
    layer's two biases summed (they only ever appear added)."""
    out, layer = {}, 0
    while f"{key}.weight_ih_l{layer}" in sd:
        out[f"lstm{layer}.w_ih"] = sd[f"{key}.weight_ih_l{layer}"].detach().float().clone()
        out[f"lstm{layer}.w_hh"] = sd[f"{key}.weight_hh_l{layer}"].detach().float().clone()
        out[f"lstm{layer}.b"] = (sd[f"{key}.bias_ih_l{layer}"]
                                 + sd[f"{key}.bias_hh_l{layer}"]).detach().float()
        layer += 1
    return out


def import_torch_strided_generator(path: str, n_strides: int = 4) -> Dict[str, torch.Tensor]:
    """main14b_2 generator .pth -> the state_dict of models.StridedGenerator
    (torch layout: E embedding, init_conv, encoder_blocks.{i} ResidualBlocks,
    proj Linear, lstm (2 layers), final_conv_enc, decoder_blocks alternating
    ConvTranspose1d / ResidualBlock, final_conv_dec; ref:
    py/main14b_2.py:105-178).  Torch's Linear and ConvTranspose layouts are
    the port's already."""
    sd = _load_torch_state_dict(path)
    modules = {"init_conv": "init_conv", "proj": "proj", "embedding": "E",
               "final_conv_enc": "final_conv_enc", "final_conv_dec": "final_conv_dec"}
    for i in range(n_strides):
        modules.update(_strided_resblock(f"enc{i}", f"encoder_blocks.{i}", sd))
        modules[f"dec_up{i}"] = f"decoder_blocks.{2 * i}"
        modules.update(_strided_resblock(f"dec_res{i}", f"decoder_blocks.{2 * i + 1}", sd))
    return {**_renamed(sd, modules), **_lstm_layers(sd, "lstm")}


def import_torch_strided_detector(path: str, n_strides: int = 4) -> Dict[str, torch.Tensor]:
    """main14b_2 detector .pth -> the state_dict of models.StridedDetector
    (torch layout: init_conv, encoder_blocks.{i}, upsample_blocks alternating
    ConvTranspose1d / ResidualBlock, final_conv; ref:
    py/main14b_2.py:180-224)."""
    sd = _load_torch_state_dict(path)
    modules = {"init_conv": "init_conv", "final_conv": "final_conv"}
    for i in range(n_strides):
        modules.update(_strided_resblock(f"enc{i}", f"encoder_blocks.{i}", sd))
        modules[f"up{i}"] = f"upsample_blocks.{2 * i}"
        modules.update(_strided_resblock(f"up_res{i}", f"upsample_blocks.{2 * i + 1}", sd))
    return _renamed(sd, modules)
