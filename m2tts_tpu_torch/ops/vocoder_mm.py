"""Matmul-form vocoder: packed weights and the plain PyTorch forward.

Counterpart of ``m2tts_tpu/ops/vocoder_mm.py``. Both vocoder ops have
exact dense-matmul forms with time on the M axis:

- conv k3  →  concat(x_{t-1}, x_t, x_{t+1}) [T, 3C] @ W [3C, C']
- tconv(k=2r, s=r, p=r/2)  →  sub-pixel conv: out[q·r + j] =
  concat(x_{q-1}, x_q, x_{q+1}) @ W' [3C, r·C'] (column block j), where
  W' is the (in, out, 2r) kernel scattered by m = −δ·r + j + r/2 (zero
  where m falls outside [0, 2r): for phase j < r/2 the x_{q+1} block is
  zero, for j ≥ r/2 the x_{q-1} block).

``vocoder_mm_forward`` is the plain version of the fused CUDA kernels
(``ops/cuda/vocoder.py``), and ``vocoder_mm_stage`` of one of their stage
launches: the same packed weights, the same function and,
under ``compute_dtype='bf16'``, the same rounding points — matmul inputs
rounded to bf16, products summed in f32, biases, the residual add and tanh
in f32, activations rounded to bf16 after the input conv, after each leaky
ReLU and after each residual add.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def pack_conv3(weight: torch.Tensor, bias: torch.Tensor) -> Dict:
    """torch Conv1d weight (out, in, 3) → rows [x_{t-1}; x_t; x_{t+1}]
    of a [3·in, out] matrix (the flax kernel (3, in, out) flattened)."""
    cout, cin, k = weight.shape
    if k != 3:
        raise ValueError(f"pack_conv3 needs a k=3 kernel, got k={k}")
    w = weight.detach().to(torch.float32).permute(2, 1, 0).reshape(3 * cin, cout)
    return {"w": w.contiguous(), "b": bias.detach().to(torch.float32).clone()}


def pack_tconv(weight: torch.Tensor, bias: torch.Tensor, rate: int) -> Dict:
    """(in, out, 2r) transposed-conv kernel → [3·in, r·out] sub-pixel
    matrix."""
    cin, cout, k = weight.shape
    if k != 2 * rate:
        raise ValueError(f"kernel size {k} != 2*rate ({2 * rate})")
    if rate % 2:
        raise ValueError(f"pack_tconv requires an even rate, got {rate}")
    half = rate // 2
    weight = weight.detach().to(torch.float32)
    W = torch.zeros((3 * cin, rate * cout), dtype=torch.float32,
                    device=weight.device)
    for j in range(rate):
        for block, delta in ((0, -1), (1, 0), (2, 1)):
            m = -delta * rate + j + half
            if 0 <= m < k:
                W[block * cin:(block + 1) * cin,
                  j * cout:(j + 1) * cout] = weight[:, :, m]
    return {"w": W, "b": bias.detach().to(torch.float32).clone(),
            "rate": rate, "cout": cout}


def pack_vocoder_weights(vocoder: torch.nn.Module,
                         compute_dtype: str = "f32") -> Dict:
    """Port ``Vocoder`` module → packed matmul-form weights, on the
    module's device. Weight matrices are stored in ``compute_dtype``;
    biases stay f32."""
    wdt = DTYPES[compute_dtype]

    def conv(c):
        p = pack_conv3(c.conv.weight, c.conv.bias)
        p["w"] = p["w"].to(wdt)
        return p

    packed: Dict = {
        "input_conv": conv(vocoder.input_conv),
        "output_conv": conv(vocoder.output_conv),
        "stages": [],
    }
    for i, r in enumerate(vocoder.upsample_rates):
        up = getattr(vocoder, f"upsample{i}")
        res = getattr(vocoder, f"resblock{i}")
        t = pack_tconv(up.weight, up.bias, r)
        t["w"] = t["w"].to(wdt)
        packed["stages"].append({"tconv": t, "res1": conv(res.conv1),
                                 "res2": conv(res.conv2)})
    return packed


def _neighbors(x: torch.Tensor) -> torch.Tensor:
    """[..., T, C] → [..., T, 3C] with zero boundary (SAME padding)."""
    zeros = torch.zeros_like(x[..., :1, :])
    up = torch.cat([zeros, x[..., :-1, :]], dim=-2)   # x_{t-1}
    dn = torch.cat([x[..., 1:, :], zeros], dim=-2)    # x_{t+1}
    return torch.cat([up, x, dn], dim=-1)


def _mm(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """x @ w with both rounded to ``dt`` and the products summed in f32
    (a bf16×bf16 product is exact in f32)."""
    return torch.matmul(x.to(dt).float(), w.to(dt).float())


def conv3_mm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             dt: torch.dtype = torch.float32) -> torch.Tensor:
    return _mm(_neighbors(x), w, dt) + b.float()


def tconv_mm(x: torch.Tensor, packed: Dict,
             dt: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, T, Cin] → [B, T·r, Cout]."""
    B, T, _ = x.shape
    r, cout = packed["rate"], packed["cout"]
    y = _mm(_neighbors(x), packed["w"], dt)
    return y.reshape(B, T * r, cout) + packed["b"].float()


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.1 * x)


def vocoder_mm_stage(x: torch.Tensor, stage: Dict, dt: torch.dtype,
                     first: Optional[Dict] = None,
                     last: Optional[Dict] = None) -> torch.Tensor:
    """One upsample stage, the plain version of one stage launch of the
    fused kernels. ``first`` is the packed input conv when this is the
    first stage (``x`` is then the f32 mel [B, T, mel]), ``last`` the packed
    output conv when it is the last (the result is then the f32 waveform
    [B, T·r]); otherwise ``x`` and the result are activations [B, T, C] in
    ``dt``."""
    if first is not None:
        x = conv3_mm(x.float(), **first, dt=dt).to(dt)
    y = _leaky(tconv_mm(x, stage["tconv"], dt)).to(dt)
    h = _leaky(conv3_mm(y, **stage["res1"], dt=dt)).to(dt)
    x = (y.float() + conv3_mm(h, **stage["res2"], dt=dt)).to(dt)
    if last is not None:
        x = torch.tanh(conv3_mm(x, **last, dt=dt))[..., 0]
    return x


def vocoder_mm_forward(mel: torch.Tensor, packed: Dict,
                       compute_dtype: str = "f32") -> torch.Tensor:
    """[B, T, mel] → [B, T·prod(rates)] f32 waveform (tanh output)."""
    dt = DTYPES[compute_dtype]
    stages = packed["stages"]
    x = mel
    for i, stage in enumerate(stages):
        x = vocoder_mm_stage(
            x, stage, dt,
            first=packed["input_conv"] if i == 0 else None,
            last=packed["output_conv"] if i == len(stages) - 1 else None)
    return x
