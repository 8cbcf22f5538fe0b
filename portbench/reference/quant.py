"""Roundings for the control: the reference computed one precision below the
one the configuration states, in the program's place. Each is a pair
(operands of the products, activations held between operations).

- ``fp8``: the step below bfloat16, in the places the program holds
  bfloat16: every operand and every activation is scaled per tensor so its
  largest magnitude maps to float8 e4m3's largest finite value (448),
  rounded to e4m3 and scaled back; products accumulate in float32.
- ``tf32``: the step below float32 with TF32 off: the products' operands'
  mantissas rounded to 10 bits (round to nearest, ties away), as the
  tensor cores read a TF32 operand; activations stay float32.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    amax = x.abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32)


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


ROUNDINGS = {"fp8": (fp8, fp8), "tf32": (tf32, _same)}
