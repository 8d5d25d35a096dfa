"""True-fp32 context for the card.

PyTorch runs fp32 matrix products in full fp32 by default but lets cuDNN
run fp32 convolutions in TF32 (about three decimal digits).  The JAX
package's strict path is true fp32 (its DSP pins Precision.HIGHEST), so the
port turns both TF32 switches off wherever it promises fp32.  A context
around a forward call does not reach its backward, which autograd runs
later, so the DSP's convolutions go through conv1d_fp32, which turns TF32 off
in both directions.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """Turn off TF32 for cuDNN convolutions and CUDA matmuls, restoring the
    caller's settings on exit.  The switches are process-wide, so this is
    not for use from several threads at once."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


class _Conv1dFp32(torch.autograd.Function):
    """conv1d by a constant kernel, TF32 off in the forward and in the
    backward (the gradient of the input only: the kernel is a constant)."""

    @staticmethod
    def forward(ctx, x, weight, stride):
        ctx.save_for_backward(weight)
        ctx.stride, ctx.x_shape = stride, x.shape
        with no_tf32():
            return F.conv1d(x, weight, stride=stride)

    @staticmethod
    def backward(ctx, grad_out):
        (weight,) = ctx.saved_tensors
        with no_tf32():
            grad_x = torch.nn.grad.conv1d_input(ctx.x_shape, weight, grad_out, stride=ctx.stride)
        return grad_x, None, None


def conv1d_fp32(x: torch.Tensor, weight: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """F.conv1d(x, weight, stride=stride) of an fp32 (N, C, L) input by a
    constant fp32 kernel, in true fp32 on the card in both directions (the
    JAX package's Precision.HIGHEST, which its gradients inherit)."""
    return _Conv1dFp32.apply(x, weight, stride)
