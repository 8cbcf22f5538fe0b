"""Wrapper of the fused vocoder kernel (``csrc/vocoder_fused.cu``).

Replaces the TPU kernels ``m2tts_tpu/ops/pallas/vocoder_packed.py``
(``fused_vocoder_packed_forward``) and ``m2tts_tpu/ops/pallas/vocoder.py``
(``fused_vocoder_forward``): the whole HiFi-GAN-lite vocoder, mel
``[B, T, C_mel]`` f32 → audio ``[B, T·U]`` f32, on the packed weights of
``ops/vocoder_mm.py``, in f32 or with bf16 matmul inputs.

What bounds it on the H100: operations. At the flagship widths the vocoder
does ~11.9 MFLOP per mel frame (zero tconv taps skipped) and moves ~74 KB
of f32 intermediates per frame between stages, far above the card's
bytes-to-FLOP balance, so without tensor cores by the f32 FMA rate. The
design runs f32 FMA loops in both compute dtypes: one launch per upsample
stage with the stage's y and h in shared memory, the input conv fused into
the first stage and the output conv + tanh into the last, weights read
through L2. Tensor cores (wgmma/TMA) and a fully fused schedule are the
next step.

Unlike the TPU kernels there is no alignment rule: any B ≥ 1 and T ≥ 1 go
through the kernel, which masks the ragged edge itself, so there is no
per-shape fallback. For a CPU tensor the wrapper runs the plain version,
``vocoder_mm_forward``; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from m2tts_tpu_torch.ops.vocoder_mm import DTYPES, vocoder_mm_forward

#: calls of ``fused_vocoder_forward`` that launched the kernel (one call
#: launches one kernel per upsample stage)
LAUNCHES = 0


def _weights(packed: Dict, dt: torch.dtype, device) -> List[Dict]:
    """Per-stage weight tensors in the kernel's dtypes, checked."""
    def w(t, rows, cols):
        if t.shape != (rows, cols):
            raise ValueError(f"packed weight shape {tuple(t.shape)} != "
                             f"{(rows, cols)}")
        return t.to(device=device, dtype=dt).contiguous()

    def bias(t, n):
        if t.shape != (n,):
            raise ValueError(f"packed bias shape {tuple(t.shape)} != {(n,)}")
        return t.to(device=device, dtype=torch.float32).contiguous()

    stages = []
    iw = packed["input_conv"]["w"]
    c_mel, cin = iw.shape[0] // 3, iw.shape[1]
    for st in packed["stages"]:
        t = st["tconv"]
        r, cout = t["rate"], t["cout"]
        stages.append({
            "r": r, "c_in": cin, "c_out": cout,
            "w_t": w(t["w"], 3 * cin, r * cout), "b_t": bias(t["b"], cout),
            "w_r1": w(st["res1"]["w"], 3 * cout, cout),
            "b_r1": bias(st["res1"]["b"], cout),
            "w_r2": w(st["res2"]["w"], 3 * cout, cout),
            "b_r2": bias(st["res2"]["b"], cout),
        })
        cin = cout
    stages[0]["w_in"] = w(iw, 3 * c_mel, stages[0]["c_in"])
    stages[0]["b_in"] = bias(packed["input_conv"]["b"], stages[0]["c_in"])
    stages[-1]["w_o"] = w(packed["output_conv"]["w"], 3 * cin, 1)
    stages[-1]["b_o"] = bias(packed["output_conv"]["b"], 1)
    return stages


def fused_vocoder_forward(mel: torch.Tensor, packed: Dict,
                          rates: Sequence[int],
                          compute_dtype: str = "f32") -> torch.Tensor:
    """mel [B, T, C_mel] f32 → audio [B, T·prod(rates)] f32.

    Launches on the current CUDA stream without synchronising; output and
    the stage intermediates are allocated with ``torch.empty``.
    """
    global LAUNCHES
    if compute_dtype not in DTYPES:
        raise ValueError(f"Unknown compute_dtype {compute_dtype!r}")
    rates = tuple(int(r) for r in rates)
    if tuple(st["tconv"]["rate"] for st in packed["stages"]) != rates:
        raise ValueError(f"rates {rates} do not match the packed weights")
    if mel.dim() != 3 or mel.dtype != torch.float32:
        raise ValueError(f"mel must be [B, T, C] float32, got "
                         f"{tuple(mel.shape)} {mel.dtype}")
    B, T, C = mel.shape
    if B < 1 or T < 1:
        raise ValueError(f"empty mel {tuple(mel.shape)}")
    if C * 3 != packed["input_conv"]["w"].shape[0]:
        raise ValueError(f"mel has {C} channels, weights expect "
                         f"{packed['input_conv']['w'].shape[0] // 3}")
    if mel.device.type == "cpu":
        return vocoder_mm_forward(mel, packed, compute_dtype)
    if mel.device.type != "cuda":
        raise ValueError(f"unsupported device {mel.device}")
    if not mel.is_contiguous():
        raise ValueError("mel must be contiguous")

    from m2tts_tpu_torch.ops.cuda.build import check, load

    lib = load("vocoder_fused")
    dt = DTYPES[compute_dtype]
    stages = _weights(packed, dt, mel.device)
    stream = torch.cuda.current_stream(mel.device).cuda_stream
    x, t_in = mel, T
    for i, st in enumerate(stages):
        first, last = i == 0, i == len(stages) - 1
        t_out = t_in * st["r"]
        out = (torch.empty((B, t_out), dtype=torch.float32, device=mel.device)
               if last else
               torch.empty((B, t_out, st["c_out"]), dtype=dt, device=mel.device))
        ptr = lambda k: st[k].data_ptr() if k in st else None  # noqa: E731
        err = lib.m2tts_vocoder_stage(
            x.data_ptr(), out.data_ptr(), ptr("w_in"), ptr("b_in"),
            ptr("w_t"), ptr("b_t"), ptr("w_r1"), ptr("b_r1"),
            ptr("w_r2"), ptr("b_r2"), ptr("w_o"), ptr("b_o"),
            B, t_in, C, st["c_in"], st["c_out"], st["r"], int(first),
            int(last), int(compute_dtype == "bf16"), stream)
        check(err, f"vocoder stage {i} launch")
        x, t_in = out, t_out
    LAUNCHES += 1
    return x


def stage_plan(rates: Sequence[int], c_mel: int, channels: int,
               compute_dtype: str = "f32") -> List[Dict]:
    """Tile (input frames per block) and shared-memory bytes of each stage
    launch, as the kernel library computes them (needs the built
    library)."""
    import ctypes

    from m2tts_tpu_torch.ops.cuda.build import load

    lib = load("vocoder_fused")
    plan, cin = [], channels
    for i, r in enumerate(rates):
        q, smem = ctypes.c_int(), ctypes.c_longlong()
        lib.m2tts_vocoder_stage_plan(1 << 20, c_mel, cin, cin // 2, r,
                                     int(i == 0), int(i == len(rates) - 1),
                                     int(compute_dtype == "bf16"),
                                     ctypes.byref(q), ctypes.byref(smem))
        plan.append({"stage": i, "rate": r, "c_in": cin, "c_out": cin // 2,
                     "q_tile": q.value, "smem_bytes": smem.value})
        cin //= 2
    return plan
