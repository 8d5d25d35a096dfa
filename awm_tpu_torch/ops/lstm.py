"""Plain PyTorch LSTM: forward, training forward and backward (counterpart of
awm_tpu/ops/lstm.py and of the arithmetic of awm_tpu/ops/pallas/lstm_kernel.py).

These are the plain versions of the CUDA kernels in ops/csrc/: the wrappers
in ops/lstm_kernel.py take them for CPU tensors, the CPU tests hold them
against the JAX package, and chip_smoke.py holds each kernel against its
plain version on the card.  Torch gate order (i, f, g, o) and one summed
bias b = b_ih + b_hh.

Precision follows the input dtype, as the TPU kernels' does
(awm_tpu/ops/pallas/lstm_kernel.py module doc):
- fp32 x: everything fp32.
- bf16 x: x, both weight matrices and the h fed to the recurrent product are
  rounded to bf16; products are exact in fp32 and accumulate in fp32, and
  the bias, gates and (h, c) state stay fp32.  y is stored bf16.
- backward: da is rounded to the operand type for every product (dh_{t-1},
  dx, dW_ih, dW_hh); db sums the fp32 da.  Weight gradients are fp32, dx is
  in x's dtype.
"""

from __future__ import annotations

import torch


def matmul_dtype(x_dtype: torch.dtype) -> torch.dtype:
    """bf16 inputs keep bf16 matmul operands; everything else runs fp32."""
    return torch.bfloat16 if x_dtype == torch.bfloat16 else torch.float32


def _operand(t: torch.Tensor, mm: torch.dtype) -> torch.Tensor:
    """t rounded to the operand type and widened back: a product of two bf16
    values is exact in fp32, so an fp32 matmul of such operands accumulates
    as the kernels' bf16-in / fp32-accumulate products do."""
    return t.to(mm).float()


def _recurrence(x, w_ih, w_hh, b, keep_c: bool):
    bsz, t, _ = x.shape
    hdim = w_hh.shape[1]
    mm = matmul_dtype(x.dtype)
    w_hh_t = _operand(w_hh, mm).t()
    xp = torch.matmul(_operand(x, mm), _operand(w_ih, mm).t())  # (B, T, 4H)
    xp += b.float()  # in place: one (B, T, 4H) buffer at the card's largest widths
    h = torch.zeros(bsz, hdim, dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    y = torch.empty(bsz, t, hdim, dtype=x.dtype, device=x.device)
    cprev = torch.empty(bsz, t, hdim, dtype=torch.float32, device=x.device) if keep_c else None
    for step in range(t):
        gates = torch.addmm(xp[:, step], _operand(h, mm), w_hh_t)
        i, f, g, o = gates.chunk(4, dim=1)
        if keep_c:
            cprev[:, step] = c
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        y[:, step] = h
    return y, cprev


def lstm_cell(
    xp_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor, w_hh: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One step (awm_tpu/ops/lstm.py::lstm_cell).  xp_t: (B, 4H) pre-projected
    input (+bias already added), w_hh: (4H, H) torch layout.  Returns
    (h', c').  The recurrent product accumulates in fp32 whatever the
    operands' type (the JAX cell's preferred_element_type=float32)."""
    gates = xp_t + torch.matmul(h.float(), w_hh.float().t())
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_forward(
    x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Single-layer LSTM over (B, T, D) -> (B, T, H), zero initial state.

    w_ih: (4H, D), w_hh: (4H, H), b: (4H,).  Output dtype is x's.
    """
    return _recurrence(x, w_ih, w_hh, b, keep_c=False)[0]


def lstm_stack(x: torch.Tensor, layers) -> torch.Tensor:
    """Multi-layer LSTM (awm_tpu/ops/lstm.py::lstm_stack; main14b_2 stacks
    2): lstm_forward layer by layer, each layer a mapping with 'w_ih',
    'w_hh' and 'b'."""
    for p in layers:
        x = lstm_forward(x, p["w_ih"], p["w_hh"], p["b"])
    return x


def lstm_forward_train(
    x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """lstm_forward that also returns the cell state before every step:
    (y (B, T, H) in x's dtype, cprev (B, T, H) fp32, zero at t=0).  The
    plain version of kernel B (the TPU's _forward_train)."""
    return _recurrence(x, w_ih, w_hh, b, keep_c=True)


def lstm_backward(
    x: torch.Tensor,
    y: torch.Tensor,
    cprev: torch.Tensor,
    dy: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    b: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradient of lstm_forward_train's y, given dy (B, T, H) fp32.
    Returns (dx in x's dtype, dW_ih (4H, D), dW_hh (4H, H), db (4H,) fp32).
    The plain version of kernel C (the TPU's _backward): h_{t-1} is y
    shifted by one step (zero at t=0), the gates are recomputed, and only
    the (dh, dc) carry runs as a reverse-time loop."""
    bsz, t, hdim = y.shape
    mm = matmul_dtype(x.dtype)
    xo = _operand(x, mm)
    w_ih_o, w_hh_o = _operand(w_ih, mm), _operand(w_hh, mm)
    hprev = torch.zeros(bsz, t, hdim, dtype=torch.float32, device=x.device)
    hprev[:, 1:] = _operand(y[:, :-1], mm)
    gates = torch.matmul(xo, w_ih_o.t())
    gates += b.float()
    gates += torch.matmul(hprev, w_hh_o.t())  # (x W_ih^T + b) + h W_hh^T, in place
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)
    tanh_c = torch.tanh(f * cprev + i * g)
    dy = dy.float()
    da = torch.empty(bsz, t, 4 * hdim, dtype=torch.float32, device=x.device)
    dh = torch.zeros(bsz, hdim, dtype=torch.float32, device=x.device)
    dc = torch.zeros_like(dh)
    for step in range(t - 1, -1, -1):
        it, ft, gt, ot, tc = i[:, step], f[:, step], g[:, step], o[:, step], tanh_c[:, step]
        dh_total = dy[:, step] + dh
        da_o = dh_total * tc * ot * (1.0 - ot)
        dc_total = dc + dh_total * ot * (1.0 - tc * tc)
        da_i = dc_total * gt * it * (1.0 - it)
        da_f = dc_total * cprev[:, step] * ft * (1.0 - ft)
        da_g = dc_total * it * (1.0 - gt * gt)
        da_t = torch.cat([da_i, da_f, da_g, da_o], dim=1)
        da[:, step] = da_t
        dh = torch.matmul(_operand(da_t, mm), w_hh_o)
        dc = dc_total * ft
    da_o = _operand(da, mm).reshape(bsz * t, 4 * hdim)
    dx = torch.matmul(da_o, w_ih_o).reshape(bsz, t, -1).to(x.dtype)
    dw_ih = torch.matmul(da_o.t(), xo.reshape(bsz * t, -1))
    dw_hh = torch.matmul(da_o.t(), hprev.reshape(bsz * t, hdim))
    db = da.sum(dim=(0, 1))
    return dx, dw_ih, dw_hh, db
