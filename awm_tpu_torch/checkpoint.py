"""Weights and architecture for the port (counterpart of awm_tpu/checkpoint.py).

The port reads no orbax tree.  A JAX checkpoint crosses over once as an
``.npz`` of its ``{'params', 'batch_stats'}`` tree flattened to ``/``-joined
keys (``params/gen/enc_conv/w``); ``assets/shapecap.npz`` is the committed
shapecap checkpoint (evidence/r5/shapecap/ckpt_best), and
``assets/awm_arch.json`` its architecture sidecar; ``assets/t_flagship.npz``
and ``assets/t_flagship_arch.json`` are evidence/r5/T_flagship/ckpt_best, the
same architecture trained without the shaping chain.  ``variables_from_flax``
maps one network's tree onto the port's ``state_dict``: the inverse of the
JAX importer's ``_conv`` / ``_conv_t`` / ``_bn`` / LSTM layouts
(awm_tpu/checkpoint.py:289-373).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from awm_tpu_torch.config import ModelConfig, ShapingConfig

ARCH_FILE = "awm_arch.json"
ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
SHAPECAP_NPZ = os.path.join(ASSETS, "shapecap.npz")
SHAPECAP_ARCH = os.path.join(ASSETS, ARCH_FILE)
T_FLAGSHIP_NPZ = os.path.join(ASSETS, "t_flagship.npz")
T_FLAGSHIP_ARCH = os.path.join(ASSETS, "t_flagship_arch.json")

# flax modules that are ConvTranspose1d (their (k, in, out) weight becomes
# torch's (in, out, k), without a flip); every other 'w' is a Conv1d.
_TRANSPOSED = frozenset({"dec_deconv"})


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
    port does not read (the strided family's) are dropped."""
    arch = dict(arch or {})
    shaping = arch.pop("shaping", None)
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    model = ModelConfig(**{k: v for k, v in arch.items() if k in known})
    if shaping is None:
        return model, None
    sknown = {f.name for f in dataclasses.fields(ShapingConfig)}
    return model, ShapingConfig(**{k: v for k, v in shaping.items() if k in sknown})


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
    if "w" in keys and keys <= {"w", "b"}:  # Conv1d / ConvTranspose1d
        perm = (1, 2, 0) if name in _TRANSPOSED else (2, 1, 0)
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


def load_models(params_npz: str = SHAPECAP_NPZ, arch_json: str = SHAPECAP_ARCH):
    """(generator, detector, ModelConfig, ShapingConfig or None) with the
    weights of a flattened .npz, fp32 on the CPU, in eval mode."""
    from awm_tpu_torch.models import build_models

    model_cfg, shaping = configs_from_arch(read_arch(arch_json))
    gen, det = build_models(model_cfg)
    nets = load_npz(params_npz)
    for net, name in ((gen, "gen"), (det, "det")):
        sub = {part: nets.get(part, {}).get(name, {}) for part in ("params", "batch_stats")}
        net.load_state_dict(variables_from_flax(sub), strict=True)
        net.eval()
    return gen, det, model_cfg, shaping


def load_into(gen, det, params_npz: str) -> list:
    """Copy a flattened .npz's weights and BN statistics into existing
    networks (a fine-tune's start, the JAX package's restore_params with
    allow_missing).  Returns the names left at their initial values (a
    parameter the checkpoint lacks, e.g. a new message encoder); a name the
    networks lack, or a shape that differs, raises."""
    nets = load_npz(params_npz)
    missing = []
    for net, name in ((gen, "gen"), (det, "det")):
        sub = {part: nets.get(part, {}).get(name, {}) for part in ("params", "batch_stats")}
        result = net.load_state_dict(variables_from_flax(sub), strict=False)
        if result.unexpected_keys:
            raise ValueError(f"{params_npz}: {name} has no {sorted(result.unexpected_keys)}")
        missing += [f"{name}.{k}" for k in result.missing_keys]
    return missing
