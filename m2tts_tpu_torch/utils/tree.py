"""State-dict helpers shared by training and checkpoints.

Counterparts of ``m2tts_tpu/utils/tree.py``: the bf16 compute-cast policy
(float32 tensors become bfloat16, every other dtype passes through) and the
finiteness check that guards checkpoint writes.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def cast_params_bf16(state: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Cast every float32 tensor to bfloat16; leave other dtypes alone.
    The cast is differentiable: gradients flow back to the f32 tensors."""
    return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
            for k, v in state.items()}


def tree_finite(tree: Any) -> bool:
    """True iff every floating tensor in a nest of dicts, lists and tuples
    is fully finite. Call it on host copies: each tensor is read once."""
    if isinstance(tree, torch.Tensor):
        return not (tree.is_floating_point() or tree.is_complex()) \
            or bool(torch.isfinite(tree).all())
    if isinstance(tree, dict):
        return all(tree_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(tree_finite(v) for v in tree)
    return True
