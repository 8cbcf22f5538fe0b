"""Core neural blocks in PyTorch, channel-last ``[B, T, C]`` at every
public boundary.

Counterparts of ``m2tts_tpu/models/components.py``. Submodule and
parameter names follow the flax param paths (``attn.qkv``, ``conv1d.conv``,
``norm1`` ...) so ``utils/params.py`` converts weights by name alone.
Convolutions transpose to torch's ``[B, C, T]`` internally.

Every LayerNorm uses eps 1e-6, flax's default (torch's is 1e-5). Dropout
draws its mask from a generator the caller sets (``Dropout.generator``), so
a trainer can make the noise of a step a function of the step.

On a device mesh (``parallel/partition.py::shard_module``) a ``Dropout``
draws the global batch's mask and keeps this rank's slice, and with a
'model' axis above one the attention and FFN run this rank's heads and
columns (``tp_group``) and sum the partial outputs over 'model'. Without a
mesh none of that is set and the plain path runs.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from m2tts_tpu_torch.parallel.mesh import copy_to_model, reduce_from_model

LN_EPS = 1e-6  # flax.linen.LayerNorm default


def sinusoidal_position_encoding(max_len: int, dim: int,
                                 dtype=torch.float32,
                                 device=None) -> torch.Tensor:
    """Transformer PE table [max_len, dim]: sin on even, cos on odd
    columns (computed in f32, then cast)."""
    position = torch.arange(max_len, dtype=torch.float32,
                            device=device)[:, None]
    div_term = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                      device=device)
                         * -(math.log(10000.0) / dim))
    angles = position * div_term[None, :]
    pe = torch.zeros((max_len, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles[:, : dim // 2])
    return pe.to(dtype)


def padding_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """lengths [B] → bool mask [B, max_length], True on valid positions."""
    return (torch.arange(max_length, device=lengths.device)[None, :]
            < lengths[:, None])


class Dropout(nn.Module):
    """Inverted dropout as flax computes it: keep each element with
    probability 1 - p and divide the kept ones by 1 - p, in the input's
    dtype. The mask comes from ``self.generator`` (a ``torch.Generator`` on
    the input's device; the device's default generator when None). The
    identity in ``eval()`` and at p = 0.

    ``shard`` (set on a mesh) lists ``(dim, index, count)``: ``x`` is slice
    ``index`` of ``count`` along ``dim`` of the global tensor, so the mask is
    drawn at the global shape and sliced, and every layout of the mesh draws
    the same global mask."""

    def __init__(self, p: float = 0.1):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None
        self.shard: Optional[List[Tuple[int, int, int]]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        shape = list(x.shape)
        for dim, _, count in self.shard or ():
            shape[dim] *= count
        u = torch.rand(shape, generator=self.generator, device=x.device)
        for dim, index, _ in self.shard or ():
            u = u.narrow(dim, index * x.shape[dim], x.shape[dim])
        keep = u >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class MultiHeadSelfAttention(nn.Module):
    """Fused-QKV self-attention (no QKV bias, features laid out
    ``(3, heads, head_dim)``). Scores at padded keys are REPLACED by -1e9,
    so a row whose keys are all padding (a length-0 pad row of a batch
    bucket) gets a uniform softmax, as in the JAX ``jnp.where``.

    With ``tp_group`` this rank holds whole heads: ``qkv.weight`` is its
    ``[3, heads·head_dim, hidden]`` slice and ``out.weight`` the matching
    ``[hidden, heads·head_dim]`` columns, whose products are summed over
    the group before the bias."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.qkv = nn.Linear(hidden_dim, 3 * hidden_dim, bias=False)
        self.dropout = Dropout(dropout_rate)
        self.out = nn.Linear(hidden_dim, hidden_dim)
        self.tp_group = None

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, S, _ = x.shape
        hd = self.hidden_dim // self.num_heads
        if self.tp_group is None:
            qkv = self.qkv(x)
        else:
            w = self.qkv.weight
            qkv = F.linear(copy_to_model(x, self.tp_group),
                           w.reshape(-1, w.shape[-1]))
        nh = qkv.shape[-1] // (3 * hd)  # this rank's heads
        qkv = qkv.reshape(B, S, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B,nh,S,hd]
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :], -1e9)
        attn = self.dropout(torch.softmax(scores, dim=-1))
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, S, nh * hd)
        if self.tp_group is None:
            return self.out(out)
        return reduce_from_model(F.linear(out, self.out.weight),
                                 self.tp_group) + self.out.bias


class FeedForward(nn.Module):
    """2-layer ReLU MLP with interior dropout. With ``tp_group`` this rank
    holds a slice of the inner columns (fc1's rows, fc2's columns) and the
    partial outputs are summed over the group before fc2's bias."""

    def __init__(self, hidden_dim: int, ffn_dim: int, dropout_rate: float = 0.1):
        super().__init__()
        self.fc1 = nn.Linear(hidden_dim, ffn_dim)
        self.dropout = Dropout(dropout_rate)
        self.fc2 = nn.Linear(ffn_dim, hidden_dim)
        self.tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is None:
            return self.fc2(self.dropout(F.relu(self.fc1(x))))
        h = self.dropout(F.relu(self.fc1(copy_to_model(x, self.tp_group))))
        return reduce_from_model(F.linear(h, self.fc2.weight),
                                 self.tp_group) + self.fc2.bias


class TransformerEncoderLayer(nn.Module):
    """Pre-norm block: x + drop(attn(ln(x))); x + drop(ffn(ln(x)))."""

    def __init__(self, hidden_dim: int, num_heads: int, ffn_dim: int,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.attn = MultiHeadSelfAttention(hidden_dim, num_heads, dropout_rate)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.ffn = FeedForward(hidden_dim, ffn_dim, dropout_rate)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.dropout(self.attn(self.norm1(x), mask))
        return x + self.dropout(self.ffn(self.norm2(x)))


def spectral_normalize(w: torch.Tensor, n_iter: int = 3) -> torch.Tensor:
    """``w`` divided by its largest singular value, with dim 0 as the
    output dim and every other dim as the input dim (a conv weight ``(out,
    in/g, k)``: the flax kernel ``(k, in/g, out)`` as a ``[k·in/g, out]``
    matrix, up to a permutation of rows, which leaves every norm alone).
    Stateless: ``n_iter`` power iterations from the uniform start
    ``1/sqrt(out)``, eps 1e-12 beside every norm, in ``w``'s dtype, so the
    same weights give the same sigma at every call (unlike
    ``torch.nn.utils.spectral_norm``, which carries ``u`` between calls)."""
    mat = w.reshape(w.shape[0], -1).t()  # [in, out]
    v = torch.full((mat.shape[1],), 1.0 / math.sqrt(mat.shape[1]),
                   dtype=mat.dtype, device=mat.device)
    for _ in range(n_iter):
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
        v = mat.t() @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
    sigma = u @ (mat @ v)
    return w / (sigma + 1e-12)


def clip_by_global_norm(grads, max_norm: float):
    """Functional global-norm gradient clipping → (clipped, global_norm),
    over a nest (dict, list, tuple) of tensors. The trainers clip inside
    their ``Optimizer``; this standalone form serves custom loops."""
    from torch.utils._pytree import tree_leaves, tree_map

    gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                           for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


class Conv1d(nn.Module):
    """1D conv on [B, T, C] with symmetric padding (k-1)·d//2 and stride
    ``stride``. With ``spectral_norm`` the weight is divided by its
    spectral norm (``spectral_normalize``) at every application; the
    parameter stays ``conv.weight`` either way."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 dilation: int = 1, groups: int = 1, use_bias: bool = True,
                 stride: int = 1, spectral_norm: bool = False):
        super().__init__()
        self.spectral_norm = spectral_norm
        self.conv = nn.Conv1d(in_features, features, kernel_size,
                              stride=stride,
                              padding=(kernel_size - 1) * dilation // 2,
                              dilation=dilation, groups=groups, bias=use_bias)

    def channels_first(self, x: torch.Tensor) -> torch.Tensor:
        """The conv on torch's [B, C, T] layout."""
        c = self.conv
        if not self.spectral_norm:
            return c(x)
        return F.conv1d(x, spectral_normalize(c.weight), c.bias, c.stride,
                        c.padding, c.dilation, c.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.channels_first(x.transpose(1, 2)).transpose(1, 2)


class ConvTranspose1d(nn.Module):
    """Transposed 1D conv with torch's ``(in, out, k)`` kernel. With the
    vocoder's (k=2r, s=r, p=r//2) it maps L frames to exactly L·r for even
    r."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int,
                 stride: int, padding: int):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.empty(in_features, out_features, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight, self.bias,
                               stride=self.stride, padding=self.padding)
        return y.transpose(1, 2)


class ConvBlock(nn.Module):
    """Conv1d + norm + ReLU + dropout. ``norm='batch'`` is BatchNorm in
    eval form: running stats and affine folded as
    ``(h - mean) * rsqrt(var + 1e-5) * scale + bias``."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 dropout_rate: float = 0.1, norm: str = "layer"):
        super().__init__()
        self.norm_kind = norm
        self.conv1d = Conv1d(in_features, features, kernel_size)
        if norm == "layer":
            self.norm = nn.LayerNorm(features, eps=LN_EPS)
        elif norm == "batch":
            self.bn_mean = nn.Parameter(torch.zeros(features))
            self.bn_var = nn.Parameter(torch.ones(features))
            self.bn_scale = nn.Parameter(torch.ones(features))
            self.bn_bias = nn.Parameter(torch.zeros(features))
        elif norm != "none":
            raise ValueError(f"Unknown norm {norm!r}")
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1d(x)
        if self.norm_kind == "layer":
            h = self.norm(h)
        elif self.norm_kind == "batch":
            h = ((h - self.bn_mean) * torch.rsqrt(self.bn_var + 1e-5)
                 * self.bn_scale + self.bn_bias)
        return self.dropout(F.relu(h))


class VariancePredictor(nn.Module):
    """2× ConvBlock + 1×1 projection → per-position scalar [B, T]."""

    def __init__(self, hidden_dim: int, kernel_size: int = 3,
                 dropout_rate: float = 0.1, norm: str = "layer"):
        super().__init__()
        self.block1 = ConvBlock(hidden_dim, hidden_dim, kernel_size,
                                dropout_rate, norm)
        self.block2 = ConvBlock(hidden_dim, hidden_dim, kernel_size,
                                dropout_rate, norm)
        self.proj = Conv1d(hidden_dim, 1, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.block2(self.block1(x)))[..., 0]


class LightweightResBlock(nn.Module):
    """conv(k, d) → leaky_relu(0.1) → conv(k, 1) + residual."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.conv1 = Conv1d(channels, channels, kernel_size, dilation=dilation)
        self.conv2 = Conv1d(channels, channels, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv1(x), negative_slope=0.1)
        return x + self.conv2(h)
