"""Train-mode BatchNorm's autograd Function (models/layers.py
_BatchNormTrain) against its plain composite and against flax's BatchNorm:
the forward, dx, dweight and dbias, and what the Function saves."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from awm_tpu_torch.models import layers
from awm_tpu_torch.models.layers import BatchNorm, batch_norm_train_plain


@pytest.fixture
def rng():
    return np.random.default_rng(20261018)


def _case(rng, b=3, c=8, t=40):
    x = (rng.standard_normal((b, c, t)) * 2.0 + 0.5).astype(np.float32)
    x[:, 5] = 0.25  # a constant channel: variance 0 (fast variance may go negative and clamp)
    dy = rng.standard_normal((b, c, t)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    return x, dy, w, bias


def _grads(fn, x, dy, w, bias, dtype):
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    tw, tb = torch.from_numpy(w).requires_grad_(True), torch.from_numpy(bias).requires_grad_(True)
    rm, rv = torch.zeros(x.shape[1]), torch.ones(x.shape[1])
    y = fn(tx, tw, tb, rm, rv)
    y.backward(torch.from_numpy(dy).to(y.dtype))
    return [t.detach().float() for t in (y, tx.grad, tw.grad, tb.grad, rm, rv)]


def _rel(a, b):
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("slab", [None, 40])
def test_batchnorm_function_matches_the_composite(rng, dtype, slab, monkeypatch):
    """The Function against batch_norm_train_plain on the same inputs: the
    output and the running statistics bit for bit (the same arithmetic);
    dx, dweight and dbias to 1e-5 of each tensor's largest value in fp32
    (the same gradient summed in another order), in bf16 dx to one bf16 ulp
    of its largest (2^-8 relative; both round the same fp32 gradient) and
    the fp32 dweight, dbias to 1e-5.  slab=40: one channel a slab (B T = 120
    values), the backward's loop over slabs."""
    if slab is not None:
        monkeypatch.setattr(layers, "BN_SLAB_ELEMS", slab)
    x, dy, w, bias = _case(rng)
    out_dtype = dtype
    fn = lambda tx, tw, tb, rm, rv: layers._BatchNormTrain.apply(tx, tw, tb, rm, rv, 1e-5, None, out_dtype)
    plain = lambda tx, tw, tb, rm, rv: batch_norm_train_plain(tx, tw, tb, rm, rv, 1e-5, None, out_dtype)
    got, ref = _grads(fn, x, dy, w, bias, dtype), _grads(plain, x, dy, w, bias, dtype)
    for k in (0, 4, 5):
        assert torch.equal(got[k], ref[k]), k
    dx_tol = 1e-5 if dtype == torch.float32 else 2.0**-8
    assert _rel(got[1], ref[1]) <= dx_tol
    assert _rel(got[2], ref[2]) <= 1e-5 and _rel(got[3], ref[3]) <= 1e-5


def test_batchnorm_function_matches_flax_vjp(rng):
    """fp32 against flax's nn.BatchNorm in train mode through jax.vjp on the
    CPU: the output 1e-5, dx, dscale and dbias 1e-4 of each tensor's
    largest value (the same gradient in two frameworks' summation orders;
    dx is a difference of sums of 120 terms)."""
    import flax.linen as fnn

    x, dy, w, bias = _case(rng)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"batch_stats": {"mean": jnp.zeros(8), "var": jnp.ones(8)}}

    def f(xj, scale, b):  # (B, T, C) as flax takes it
        out, _ = bn.apply({"params": {"scale": scale, "bias": b}, **variables}, xj, mutable=["batch_stats"])
        return out

    xj = jnp.asarray(x.transpose(0, 2, 1))
    ref, vjp = jax.vjp(f, xj, jnp.asarray(w), jnp.asarray(bias))
    rdx, rdw, rdb = vjp(jnp.asarray(dy.transpose(0, 2, 1)))
    m = BatchNorm(8).train()
    m.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(bias),
                       "running_mean": torch.zeros(8), "running_var": torch.ones(8)})
    tx = torch.from_numpy(x).requires_grad_(True)
    y = m(tx)
    y.backward(torch.from_numpy(dy))
    assert _rel(y.detach(), torch.from_numpy(np.asarray(ref).transpose(0, 2, 1).copy())) <= 1e-5
    for got, want in ((tx.grad, np.asarray(rdx).transpose(0, 2, 1)), (m.weight.grad, rdw), (m.bias.grad, rdb)):
        assert _rel(got, torch.from_numpy(np.ascontiguousarray(np.asarray(want)))) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_batchnorm_saves_its_input_and_per_channel_statistics(rng, dtype):
    """What autograd keeps for the backward: the Function saves x in its
    own dtype and per-channel tensors only; the composite it replaces keeps
    at least one more fp32 tensor of x's size (at the base preset's bf16
    step, its fp32 copy of x and its fp32 output)."""
    x = torch.from_numpy(_case(rng, b=4, c=8, t=256)[0]).to(dtype).requires_grad_(True)
    m = BatchNorm(8).train()
    m.compute_dtype = dtype

    def saved_bytes(fn):
        seen = {}

        def pack(t):
            seen[t.data_ptr(), t.dtype] = t.numel() * t.element_size()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn()
        return sum(seen.values())

    own = saved_bytes(lambda: m(x))
    plain = saved_bytes(lambda: batch_norm_train_plain(x, m.weight, m.bias, m.running_mean.clone(),
                                                       m.running_var.clone(), 1e-5, None, dtype))
    x_bytes = x.numel() * x.element_size()
    assert own <= x_bytes + 64 * 8
    assert plain >= x_bytes + 4 * x.numel()
