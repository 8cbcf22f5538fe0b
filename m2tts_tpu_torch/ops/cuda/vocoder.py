"""Wrappers of the fused vocoder kernels.

Replace the TPU kernels ``m2tts_tpu/ops/pallas/vocoder_packed.py``
(``fused_vocoder_packed_forward``) and ``m2tts_tpu/ops/pallas/vocoder.py``
(``fused_vocoder_forward``): the whole HiFi-GAN-lite vocoder, mel
``[B, T, C_mel]`` f32 → audio ``[B, T·U]`` f32, on the packed weights of
``ops/vocoder_mm.py``. Both designs run one launch per upsample stage with
the stage's y and h in shared memory, the input conv fused into the first
stage and the output conv + tanh into the last.

- ``compute_dtype='bf16'`` → ``csrc/vocoder_tc.cu``: wgmma on Hopper's
  tensor cores, bf16 matmul inputs, f32 sums. What bounds it: operations
  (~12 MFLOP per mel frame at the flagship widths) in the wide stages,
  bytes of the bf16 stage outputs in the narrow ones. Weights are packed
  here, once per weight set, into the chunk stream the kernel copies
  through its shared-memory ring, and channel counts are padded to
  multiples of 16 (the MMA's K) with zero weights.
- ``compute_dtype='f32'`` → ``csrc/vocoder_fused.cu``: f32 FMA loops,
  because neither bf16 nor TF32 tensor cores hold the f32 tolerance.

Unlike the TPU kernels there is no alignment rule: any B ≥ 1 and T ≥ 1 go
through the kernels, which mask the ragged edge themselves, so there is no
per-shape fallback. For a CPU tensor the wrappers run the plain versions
(``vocoder_mm_forward``, ``vocoder_mm_stage``); for a CUDA tensor they
launch a kernel or raise.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from m2tts_tpu_torch.ops.vocoder_mm import (DTYPES, vocoder_mm_forward,
                                            vocoder_mm_stage)

#: stage launches of the tensor-core kernel (``vocoder_tc.cu``, bf16)
LAUNCHES_TC = 0
#: stage launches of the FMA kernel (``vocoder_fused.cu``, f32)
LAUNCHES_FMA = 0

#: shared memory a block may use on Hopper, and the ring's slot count (as
#: in ``vocoder_tc.cu``)
SMEM_MAX = 227 * 1024
TC_SLOTS = 2
_MTW = 4  # 64-row m-tiles a warpgroup accumulates


def _pad16(c: int) -> int:
    return -(-c // 16) * 16


def _tile_rows(rows: int, wn: int) -> int:
    """Rows a pass's m-tiles cover (``vocoder_tc.cu::tile_rows``)."""
    return -(-rows // 64) * 64 if wn == 2 else -(-rows // 128) * 128


def _wn(ncols: int, nw: int) -> int:
    """Warpgroups side by side along the columns of a pass (1 or 2)."""
    return 2 if ncols % (2 * nw) == 0 else 1


def _group_taps(g0: int, ng: int, tconv: bool, half: int):
    """Taps [t0, t1) a weight chunk of columns [g0, g0 + ng) holds: a
    tconv's columns below ``half`` have a dead x_{q+1} tap, the rest a dead
    x_{q-1} tap."""
    t0 = 1 if tconv and g0 >= half else 0
    t1 = 2 if tconv and g0 + ng <= half else 3
    return t0, t1


def tc_geometry(cmp: int, cip: int, cop: int, r: int, first: bool,
                last: bool, q: int, nw: int, slot: int) -> Dict:
    """Rows of each pass and shared-memory bytes of one block, as
    ``vocoder_tc.cu::geometry`` lays them out."""
    N, e = q * r, 2 + int(last)
    nqy = (N + e - 1) // r - (-e) // r + 1
    nx, ny, nh = nqy + 2, N + 2 * e, N + 2 * e - 2
    n_o = N + 2 if last else N
    wn_r = _wn(cop, nw)
    rm = (max(nx + 2, _tile_rows(nx, _wn(cip, nw)) + 2) | 1) if first else 0
    rx = max(nx, _tile_rows(nqy, _wn(r * cop, nw)) + 2) | 1
    ry = max(ny, _tile_rows(nh, wn_r) + 2) | 1
    rh = max(nh, _tile_rows(n_o, wn_r) + 2) | 1
    ro = (N + 2) | 1 if last else 0

    def a128(v):
        return -(-v // 128) * 128

    off_y = a128(128 + TC_SLOTS * slot)
    off_h = a128(off_y + cop * ry * 2)
    off_m = a128(off_h + cip * rx * 2)
    off_o = a128(max(off_h + cop * rh * 2, off_m + cmp * rm * 2))
    return {"nqy": nqy, "nx": nx, "nh": nh, "n_o": n_o,
            "smem": a128(off_o + cop * ro * 2)}


def _passes(st: Dict) -> List[Dict]:
    """The k=3 passes of a stage, in launch order: input channels, output
    columns, whether it is the tconv, and its rows' key in the geometry."""
    cip, cop, r = st["cip"], st["cop"], st["r"]
    out = []
    if st["first"]:
        out.append({"name": "in", "cin": st["cmp"], "ncols": cip,
                    "tconv": False, "rows": "nx"})
    out.append({"name": "t", "cin": cip, "ncols": r * cop, "tconv": True,
                "rows": "nqy"})
    out.append({"name": "r", "cin": cop, "ncols": cop, "tconv": False,
                "rows": "nh"})
    out.append({"name": "r", "cin": cop, "ncols": cop, "tconv": False,
                "rows": "n_o"})
    return out


def _chunk_bytes(st: Dict, ps: Dict, kc: int) -> int:
    """Largest weight chunk of a pass at ``kc`` input channels a chunk."""
    nw = st["nw"]
    ng = _wn(ps["ncols"], nw) * nw
    half = (st["r"] // 2) * st["cop"]
    taps = max(t1 - t0 for t0, t1 in (
        _group_taps(g0, ng, ps["tconv"], half)
        for g0 in range(0, ps["ncols"], ng)))
    return taps * kc * ng * 2


def _tc_stage_plan(r: int, c_in: int, c_out: int, c_mel: int, first: bool,
                   last: bool) -> Dict:
    st = {"r": r, "c_in": c_in, "c_out": c_out, "c_mel": c_mel,
          "first": first, "last": last,
          "cmp": _pad16(c_mel) if first else 0, "cip": _pad16(c_in),
          "cop": _pad16(c_out)}
    st["nw"] = nw = next(w for w in (64, 32, 16)
                         if st["cip"] % w == 0 and st["cop"] % w == 0)
    # blocks an SM (the kernel's launch bounds): the narrow stages' tiles
    # need fewer registers, and more blocks hide their latencies
    blocks = {64: 1, 32: 2, 16: 3}[nw]
    budget = SMEM_MAX // blocks - (1024 if blocks > 1 else 0)
    passes = _passes(st)
    wbytes = sum(_chunk_bytes(st, ps, ps["cin"]) * ps["ncols"]
                 // (_wn(ps["ncols"], nw) * nw) for ps in passes)
    min_slot = max(_chunk_bytes(st, ps, 16) for ps in passes)
    best = None
    for q in range(1, 1024 // r + 1):
        geo = tc_geometry(st["cmp"], st["cip"], st["cop"], r, first, last, q,
                          nw, min_slot)
        tiles = [_tile_rows(geo[ps["rows"]], _wn(ps["ncols"], nw)) // 64
                 for ps in passes]
        if geo["smem"] > budget or any(
                t > _MTW * (3 - _wn(ps["ncols"], nw))
                for t, ps in zip(tiles, passes)):
            continue
        # MMA work of the padded 64-row tiles, plus the weights each block
        # streams from L2 (~128 FLOP of tensor-core time a byte) and a fixed
        # cost a block, per output frame
        flops = sum(64 * t * ps["cin"] * ps["ncols"]
                    * (2 if ps["tconv"] else 3) * 2
                    for t, ps in zip(tiles, passes))
        cost = (flops + 128 * wbytes + 2e5) / (q * r)
        if best is None or cost <= best[0]:
            best = (cost, q, geo)
    if best is None:
        raise ValueError(f"no tile fits stage r={r} {c_in}->{c_out}")
    _, q, geo = best
    # the ring takes what the buffers leave; each pass's chunk is the most
    # input channels (a multiple of 16 dividing its K) that fit a slot
    room = (budget - (geo["smem"] - TC_SLOTS * min_slot)) // TC_SLOTS
    room = min(room // 128 * 128, 64 * 1024)
    kc = {}
    for ps in passes:
        kc[ps["name"]] = max(k for k in range(16, ps["cin"] + 1, 16)
                             if ps["cin"] % k == 0
                             and _chunk_bytes(st, ps, k) <= room)
    slot = max(_chunk_bytes(st, ps, kc[ps["name"]]) for ps in passes)
    slot = -(-slot // 128) * 128
    st.update(q_tile=q, kc_in=kc.get("in", 16), kc_t=kc["t"], kc_r=kc["r"],
              slot_bytes=slot,
              smem_bytes=tc_geometry(st["cmp"], st["cip"], st["cop"], r,
                                     first, last, q, nw, slot)["smem"])
    return st


def tc_plan(rates: Sequence[int], c_mel: int, channels: int) -> List[Dict]:
    """Per-stage tiling of the tensor-core kernel: padded channels, the
    warpgroup tile width ``nw``, input frames a block ``q_tile``, channels
    a weight chunk per pass, ring slot and shared-memory bytes."""
    plan, cin = [], channels
    for i, r in enumerate(rates):
        plan.append(_tc_stage_plan(int(r), cin, cin // 2, c_mel, i == 0,
                                   i == len(rates) - 1))
        cin //= 2
    return plan


def _conv3(w: torch.Tensor, cin: int, cip: int, cols: int,
           colp: int) -> torch.Tensor:
    """Packed [3·cin, cols] conv weights → [3, cip, colp] f32, zero-padded."""
    w = w.float().reshape(3, cin, cols)
    return F.pad(w, (0, colp - cols, 0, cip - cin))


def _tc_chunks(w3: torch.Tensor, st: Dict, ps: Dict,
               kc: int) -> List[torch.Tensor]:
    """One pass's weights [3, K, ncols] → the chunks the kernel consumes, in
    its order: for each column group of ``wn·nw`` columns, for each ``kc``
    input channels, the group's live taps as [taps][kc/8][cols][8]."""
    nw = st["nw"]
    ng = _wn(ps["ncols"], nw) * nw
    half = (st["r"] // 2) * st["cop"]
    out = []
    for g0 in range(0, ps["ncols"], ng):
        t0, t1 = _group_taps(g0, ng, ps["tconv"], half)
        for k0 in range(0, ps["cin"], kc):
            blk = w3[t0:t1, k0:k0 + kc, g0:g0 + ng]
            out.append(blk.reshape(t1 - t0, kc // 8, 8, ng)
                       .permute(0, 1, 3, 2).reshape(-1))
    return out


def _tc_pack_stage(packed: Dict, i: int, st: Dict, device) -> Dict:
    """Kernel operands of stage ``i``: the chunk stream (bf16), its byte
    offsets (int32), padded biases (f32) and output-conv weights."""
    stage = packed["stages"][i]
    cin, cout, cip, cop, r = st["c_in"], st["c_out"], st["cip"], st["cop"], st["r"]
    passes = _passes(st)
    mats = []
    if st["first"]:
        mats.append(_conv3(packed["input_conv"]["w"], st["c_mel"], st["cmp"],
                           cin, cip))
    t = stage["tconv"]["w"].float().reshape(3, cin, r, cout)
    mats.append(F.pad(t, (0, cop - cout, 0, 0, 0, cip - cin))
                .reshape(3, cip, r * cop))
    mats.append(_conv3(stage["res1"]["w"], cout, cop, cout, cop))
    mats.append(_conv3(stage["res2"]["w"], cout, cop, cout, cop))
    kcs = {"in": st["kc_in"], "t": st["kc_t"], "r": st["kc_r"]}
    chunks = [c for w3, ps in zip(mats, passes)
              for c in _tc_chunks(w3, st, ps, kcs[ps["name"]])]
    off = [0]
    for c in chunks:
        off.append(off[-1] + 2 * c.numel())

    def bias(b, n):
        return F.pad(b.float(), (0, n - b.numel())).to(device).contiguous()

    ops = {
        "w": torch.cat(chunks).to(device=device, dtype=torch.bfloat16),
        "off": torch.tensor(off, dtype=torch.int32, device=device),
        "nchunks": len(chunks),
        "b_t": bias(stage["tconv"]["b"], cop),
        "b_r1": bias(stage["res1"]["b"], cop),
        "b_r2": bias(stage["res2"]["b"], cop),
    }
    if st["first"]:
        ops["b_in"] = bias(packed["input_conv"]["b"], cip)
    if st["last"]:
        wo = packed["output_conv"]["w"].float().reshape(3, cout)
        ops["w_o"] = F.pad(wo, (0, cop - cout)).reshape(-1).to(
            device=device, dtype=torch.bfloat16)
        ops["b_o"] = bias(packed["output_conv"]["b"], 1)
    return ops


#: tensor-core operands per weight set and device, keyed by the id of the
#: input conv's weight tensor and dropped with it
_TC_CACHE: Dict[int, tuple] = {}


def _tc_operands(packed: Dict, c_mel: int, device) -> List[Dict]:
    w = packed["input_conv"]["w"]
    hit = _TC_CACHE.get(id(w))
    if hit is None or hit[0]() is not w or hit[1] != device:
        rates = [st["tconv"]["rate"] for st in packed["stages"]]
        plan = tc_plan(rates, c_mel, w.shape[1])
        ops = [(st, _tc_pack_stage(packed, i, st, device))
               for i, st in enumerate(plan)]
        hit = (weakref.ref(w), device, ops)
        _TC_CACHE[id(w)] = hit
        weakref.finalize(w, _TC_CACHE.pop, id(w), None)
    return hit[2]


def _tc_launch(x: torch.Tensor, st: Dict, ops: Dict) -> torch.Tensor:
    """One tensor-core stage launch on the padded layout: x is the f32 mel
    (first) or [B, T, cip] bf16; returns [B, T·r, cop] bf16 or the f32
    audio (last)."""
    global LAUNCHES_TC
    from m2tts_tpu_torch.ops.cuda.build import check, load

    B, T = x.shape[:2]
    t_out = T * st["r"]
    out = (torch.empty((B, t_out), dtype=torch.float32, device=x.device)
           if st["last"] else
           torch.empty((B, t_out, st["cop"]), dtype=torch.bfloat16,
                       device=x.device))
    ptr = lambda k: ops[k].data_ptr() if k in ops else None  # noqa: E731
    err = load("vocoder_tc").m2tts_vocoder_tc_stage(
        x.data_ptr(), out.data_ptr(), ptr("w"), ptr("off"), ptr("b_in"),
        ptr("b_t"), ptr("b_r1"), ptr("b_r2"), ptr("w_o"), ptr("b_o"),
        B, T, st["c_mel"], st["cmp"], st["cip"], st["cop"], st["r"],
        int(st["first"]), int(st["last"]), st["q_tile"], st["nw"],
        st["kc_in"], st["kc_t"], st["kc_r"], st["slot_bytes"],
        ops["nchunks"], torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES_TC += 1
    check(err, f"tensor-core vocoder stage (r={st['r']}) launch")
    return out


def _fma_weights(packed: Dict, device) -> List[Dict]:
    """Per-stage f32 weight tensors of the FMA kernel, checked."""
    def w(t, rows, cols):
        if t.shape != (rows, cols):
            raise ValueError(f"packed weight shape {tuple(t.shape)} != "
                             f"{(rows, cols)}")
        return t.to(device=device, dtype=torch.float32).contiguous()

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


def _fma_launch(x: torch.Tensor, st: Dict, c_mel: int, first: bool,
                last: bool) -> torch.Tensor:
    """One FMA stage launch: x is the f32 mel (first) or [B, T, c_in] f32."""
    global LAUNCHES_FMA
    from m2tts_tpu_torch.ops.cuda.build import check, load

    B, T = x.shape[:2]
    t_out = T * st["r"]
    out = (torch.empty((B, t_out), dtype=torch.float32, device=x.device)
           if last else
           torch.empty((B, t_out, st["c_out"]), dtype=torch.float32,
                       device=x.device))
    ptr = lambda k: st[k].data_ptr() if k in st else None  # noqa: E731
    err = load("vocoder_fused").m2tts_vocoder_stage(
        x.data_ptr(), out.data_ptr(), ptr("w_in"), ptr("b_in"),
        ptr("w_t"), ptr("b_t"), ptr("w_r1"), ptr("b_r1"),
        ptr("w_r2"), ptr("b_r2"), ptr("w_o"), ptr("b_o"),
        B, T, c_mel, st["c_in"], st["c_out"], st["r"], int(first),
        int(last), torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES_FMA += 1
    check(err, f"FMA vocoder stage (r={st['r']}) launch")
    return out


def _check_mel(mel: torch.Tensor, packed: Dict, compute_dtype: str) -> None:
    if compute_dtype not in DTYPES:
        raise ValueError(f"Unknown compute_dtype {compute_dtype!r}")
    if mel.dim() != 3 or mel.dtype != torch.float32:
        raise ValueError(f"mel must be [B, T, C] float32, got "
                         f"{tuple(mel.shape)} {mel.dtype}")
    B, T, C = mel.shape
    if B < 1 or T < 1:
        raise ValueError(f"empty mel {tuple(mel.shape)}")
    if C * 3 != packed["input_conv"]["w"].shape[0]:
        raise ValueError(f"mel has {C} channels, weights expect "
                         f"{packed['input_conv']['w'].shape[0] // 3}")


def _check_device(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("input must be contiguous")


def fused_vocoder_forward(mel: torch.Tensor, packed: Dict,
                          rates: Sequence[int],
                          compute_dtype: str = "f32") -> torch.Tensor:
    """mel [B, T, C_mel] f32 → audio [B, T·prod(rates)] f32.

    bf16 runs the tensor-core kernel, f32 the FMA kernel, one launch per
    stage on the current CUDA stream without synchronising; the output and
    the stage intermediates are allocated with ``torch.empty``.
    """
    _check_mel(mel, packed, compute_dtype)
    rates = tuple(int(r) for r in rates)
    if tuple(st["tconv"]["rate"] for st in packed["stages"]) != rates:
        raise ValueError(f"rates {rates} do not match the packed weights")
    if mel.device.type == "cpu":
        return vocoder_mm_forward(mel, packed, compute_dtype)
    _check_device(mel)
    c_mel = mel.shape[2]
    x = mel
    if compute_dtype == "bf16":
        for st, ops in _tc_operands(packed, c_mel, mel.device):
            x = _tc_launch(x, st, ops)
        return x
    stages = _fma_weights(packed, mel.device)
    for i, st in enumerate(stages):
        x = _fma_launch(x, st, c_mel, i == 0, i == len(stages) - 1)
    return x


def fused_vocoder_stage(x: torch.Tensor, packed: Dict, index: int,
                        compute_dtype: str = "f32") -> torch.Tensor:
    """Stage ``index`` alone, with the input and output of
    ``vocoder_mm_stage``: x is the f32 mel (first stage) or activations
    [B, T, C] in the compute dtype; returns the next activations, or the f32
    audio (last stage)."""
    stages = packed["stages"]
    first, last = index == 0, index == len(stages) - 1
    dt = DTYPES[compute_dtype]
    c_mel = packed["input_conv"]["w"].shape[0] // 3
    if x.device.type == "cpu":
        return vocoder_mm_stage(
            x, stages[index], dt,
            first=packed["input_conv"] if first else None,
            last=packed["output_conv"] if last else None)
    _check_device(x)
    if first:
        _check_mel(x, packed, compute_dtype)
    elif x.dtype != dt:
        raise ValueError(f"stage input must be {dt}, got {x.dtype}")
    if compute_dtype == "f32":
        st = _fma_weights(packed, x.device)[index]
        return _fma_launch(x, st, c_mel, first, last)
    st, ops = _tc_operands(packed, c_mel, x.device)[index]
    if not first and st["cip"] != x.shape[2]:
        x = F.pad(x, (0, st["cip"] - x.shape[2])).contiguous()
    out = _tc_launch(x, st, ops)
    return out if last else out[..., :st["c_out"]].contiguous()


def stage_plan(rates: Sequence[int], c_mel: int, channels: int,
               compute_dtype: str = "f32") -> List[Dict]:
    """Per-stage tiling of the kernel ``compute_dtype`` runs: for bf16 the
    tensor-core plan (``tc_plan``), for f32 the FMA kernel's tile and
    shared-memory bytes as its library computes them (needs the built
    library)."""
    if compute_dtype == "bf16":
        keys = ("r", "cip", "cop", "nw", "q_tile", "kc_in", "kc_t", "kc_r",
                "slot_bytes", "smem_bytes")
        return [{k: st[k] for k in keys}
                for st in tc_plan(rates, c_mel, channels)]
    import ctypes

    from m2tts_tpu_torch.ops.cuda.build import load

    lib = load("vocoder_fused")
    plan, cin = [], channels
    for i, r in enumerate(rates):
        q, smem = ctypes.c_int(), ctypes.c_longlong()
        lib.m2tts_vocoder_stage_plan(1 << 20, c_mel, cin, cin // 2, r,
                                     int(i == 0), int(i == len(rates) - 1),
                                     ctypes.byref(q), ctypes.byref(smem))
        plan.append({"stage": i, "rate": r, "c_in": cin, "c_out": cin // 2,
                     "q_tile": q.value, "smem_bytes": smem.value})
        cin //= 2
    return plan


def tc_smem_bytes(st: Dict) -> int:
    """Shared-memory bytes of a tensor-core stage as the kernel library
    lays them out (needs the built library); equals ``st['smem_bytes']``."""
    from m2tts_tpu_torch.ops.cuda.build import load

    return load("vocoder_tc").m2tts_vocoder_tc_smem(
        st["cmp"], st["cip"], st["cop"], st["r"], int(st["first"]),
        int(st["last"]), st["q_tile"], st["nw"], st["slot_bytes"])
