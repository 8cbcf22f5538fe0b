"""Weight-gradient lowerings of a stride-1 grouped 1-D convolution.

Counterpart of ``m2tts_tpu/ops/grouped_conv.py``. The phase-packed
discriminator (``models/discriminator.py``) runs its strided grouped convs
as stride-1 convs through ``conv1d_s1``, whose ``wgrad`` picks how the
weight gradient is computed:

- ``xla``: the plain ``F.conv1d`` with autograd's own backward (cuDNN's
  weight gradient on the card; the native lowering, as XLA's is in JAX);
- ``pergroup``: per tap, one ``bmm`` over the groups,
  ``[g, co, B·T] × [g, B·T, ci] → [g, co, ci]``;
- ``dense``: per tap, one dense ``[Cout, B·T] × [B·T, Cin]`` matmul, then
  its block diagonal ``d.view(g, co, g, ci)[gi, :, gi]``: g× the FLOPs
  of ``pergroup``, in one matmul of full width.

All three compute the same function (sums reassociated only). In
``pergroup`` and ``dense`` the forward is the plain conv and the input
gradient stays cuDNN's (``aten.convolution_backward`` asked for the input
gradient alone). Tensors are in torch's ``[B, C, T]`` layout with the
``[Cout, Cin/g, k]`` weight; no bias (the caller adds it).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

VARIANTS = ("xla", "pergroup", "dense")


def _pad_input(x: torch.Tensor, pad: Tuple[int, int]) -> torch.Tensor:
    return F.pad(x, pad) if pad != (0, 0) else x


def _conv_s1(x: torch.Tensor, w: torch.Tensor, pad: Tuple[int, int],
             groups: int) -> torch.Tensor:
    """Stride-1 grouped conv with (left, right) zero padding; symmetric
    padding goes to the conv itself, asymmetric through ``F.pad``."""
    if pad[0] == pad[1]:
        return F.conv1d(x, w, padding=pad[0], groups=groups)
    return F.conv1d(_pad_input(x, pad), w, groups=groups)


def _wgrad_pergroup(xp: torch.Tensor, dy: torch.Tensor, kp: int,
                    groups: int) -> torch.Tensor:
    """dW [Cout, Cin/g, kp] from the padded input ``xp`` [B, Cin, T+kp-1]
    and ``dy`` [B, Cout, T]: per tap one bmm batched over the groups."""
    B, Cin, _ = xp.shape
    _, Cout, T = dy.shape
    ci, co = Cin // groups, Cout // groups
    dyg = dy.reshape(B, groups, co, T).permute(1, 2, 0, 3).reshape(
        groups, co, B * T)
    taps = []
    for k in range(kp):
        xg = xp[:, :, k:k + T].reshape(B, groups, ci, T).permute(
            1, 0, 3, 2).reshape(groups, B * T, ci)
        taps.append(torch.bmm(dyg, xg).reshape(Cout, ci))
    return torch.stack(taps, dim=-1)


def _wgrad_dense(xp: torch.Tensor, dy: torch.Tensor, kp: int,
                 groups: int) -> torch.Tensor:
    """dW [Cout, Cin/g, kp]: per tap one dense [Cout, Cin] matmul, its
    diagonal blocks taken out."""
    B, Cin, _ = xp.shape
    _, Cout, T = dy.shape
    ci, co = Cin // groups, Cout // groups
    gi = torch.arange(groups, device=xp.device)
    dyf = dy.permute(1, 0, 2).reshape(Cout, B * T)
    taps = []
    for k in range(kp):
        xs = xp[:, :, k:k + T].permute(0, 2, 1).reshape(B * T, Cin)
        d = dyf @ xs  # [Cout, Cin]
        taps.append(d.view(groups, co, groups, ci)[gi, :, gi].reshape(
            Cout, ci))
    return torch.stack(taps, dim=-1)


class Conv1dS1Wgrad(torch.autograd.Function):
    """Stride-1 grouped conv whose backward computes the weight gradient
    with ``variant`` ('pergroup' or 'dense') and the input gradient with
    cuDNN's (or the CPU's) own lowering. The forward is the plain conv."""

    @staticmethod
    def forward(ctx, x, w, pad, groups, variant):
        ctx.save_for_backward(x, w)
        ctx.pad, ctx.groups, ctx.variant = pad, groups, variant
        return _conv_s1(x, w, pad, groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        pad, groups = ctx.pad, ctx.groups
        dy = dy.contiguous()
        xp = _pad_input(x, pad)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxp, _, _ = torch.ops.aten.convolution_backward(
                dy, xp, w, None, [1], [0], [1], False, [0], groups,
                [True, False, False])
            dx = dxp[:, :, pad[0]:pad[0] + x.shape[2]]
        if ctx.needs_input_grad[1]:
            fn = _wgrad_dense if ctx.variant == "dense" else _wgrad_pergroup
            dw = fn(xp, dy, w.shape[2], groups).to(w.dtype)
        return dx, dw, None, None, None


def conv1d_s1(x: torch.Tensor, w: torch.Tensor, pad: Tuple[int, int],
              groups: int, wgrad: str = "xla") -> torch.Tensor:
    """Stride-1 grouped conv ``x`` [B, Cin, T] * ``w`` [Cout, Cin/g, k]
    with (left, right) zero padding ``pad`` and the weight-gradient
    lowering ``wgrad`` (one of ``VARIANTS``)."""
    if wgrad not in VARIANTS:
        raise ValueError(f"unknown wgrad variant {wgrad!r}")
    pad = (int(pad[0]), int(pad[1]))
    if wgrad == "xla":
        return _conv_s1(x, w, pad, groups)
    return Conv1dS1Wgrad.apply(x, w, pad, groups, wgrad)
