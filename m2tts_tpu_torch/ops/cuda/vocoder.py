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
  bytes of the bf16 stage outputs in the narrow ones.
- ``compute_dtype='f32'`` → ``csrc/vocoder_tc32.cu``: wgmma on the TF32
  tensor cores with the 3×TF32 split (``tf32_split``): each operand is a
  TF32 high part plus a TF32 low part, and the three products hi·hi +
  hi·lo + lo·hi hold the f32 tolerance that one TF32 product misses.
  Bound: operations, three TF32 products per f32 product. Its tiling adds
  the tconv's layout: ``ft`` column blocks a warpgroup tile, or, in the
  wide stages, ``nq`` time rows of a tconv with swapped operands.

Both kernels share one design (``tc_plan`` tiles them). Weights are packed
here, once per weight set, into the chunk stream a kernel copies through
its shared-memory ring (for f32 each chunk holds the hi plane, then the lo
plane), and channel counts are padded to multiples of 16 with zero
weights.

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
from torch.distributed.tensor import DTensor

from m2tts_tpu_torch.ops.vocoder_mm import (DTYPES, vocoder_mm_forward,
                                            vocoder_mm_stage)

#: stage launches of the bf16 tensor-core kernel (``vocoder_tc.cu``)
LAUNCHES_TC = 0
#: stage launches of the f32 3×TF32 tensor-core kernel (``vocoder_tc32.cu``)
LAUNCHES_TC32 = 0

#: shared memory a block may use on Hopper, and the weight ring's slots
#: (as in ``tc_common.cuh``)
SMEM_MAX = 227 * 1024
TC_SLOTS = 2

#: per compute dtype, as the kernel has it: its library, bytes of an
#: activation or weight element, the MMA's K, weight planes (hi and lo for
#: 3×TF32), blocks an SM by column tile (its launch bounds), the 64-row
#: m-tiles a warpgroup
#: accumulates (f32: in the tconv by its tile's column blocks F, as
#: ``vocoder_tc32.cu::tconv_mt``); and for the planner the
#: tensor-core time of one padded MMA FLOP in bf16 FLOPs (three TF32
#: products at half the bf16 rate)
_KERNELS = {
    "bf16": {"lib": "vocoder_tc", "esize": 2, "k": 16, "planes": 1,
             "blocks": {64: 1, 32: 2, 16: 3}, "mt": 4, "tconv_mt": {1: 4},
             "mma_cost": 1},
    "f32": {"lib": "vocoder_tc32", "esize": 4, "k": 8, "planes": 2,
            "blocks": {64: 1, 32: 2, 16: 2}, "mt": 3,
            "tconv_mt": {1: 3, 2: 2, 4: 1}, "mma_cost": 6},
}
#: in the planner's unit (the time of one bf16 FLOP of an SM's tensor
#: cores, ~1/4096 of a cycle), what the f32 kernel spends beyond its
#: products, as measured on the H100: ~450 cycles an A fragment (its loads,
#: TF32 split and wait), one weight chunk's barrier, and ~3 µs a block (its
#: activation window in, its output out)
_FRAGMENT_COST = 1.8e6
_CHUNK_COST = 1e6
_BLOCK_COST = 2e7


def _tf32_bits(x: torch.Tensor, round_half: bool) -> torch.Tensor:
    """f32 → TF32 (the low 13 mantissa bits zero): to nearest, ties away
    from zero (as ``cvt.rna.tf32.f32``), or by truncation."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000 if round_half else bits) & -0x2000).view(
        torch.float32)


def tf32_split(x: torch.Tensor, rounding: str = "rna"):
    """f32 → (hi, lo) with x = hi + lo to about 2^-22 relative.

    ``rna`` (the weights, split once on the host): hi = rna(x), lo =
    rna(x − hi), both TF32. ``trunc`` (the activations, as the f32 kernel
    splits each fragment): hi = x truncated to TF32, lo = x − hi exactly;
    the tensor core reads lo's TF32 bits, which ``matmul_3xtf32`` models by
    truncating it."""
    if rounding == "rna":
        hi = _tf32_bits(x, True)
        return hi, _tf32_bits(x.float() - hi, True)
    hi = _tf32_bits(x, False)
    return hi, x.float() - hi


def matmul_3xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w by the three TF32 products the f32 kernel issues, summed in f32
    (each product of two TF32 values is exact in f32): a split as the kernel
    splits activations, w as the wrapper splits weights; drops lo·lo."""
    ah, al = tf32_split(a, "trunc")
    al = _tf32_bits(al, False)  # the tensor core's view of lo
    wh, wl = tf32_split(w)
    return ah @ wl + al @ wh + ah @ wh


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
                last: bool, q: int, nw: int, slot: int,
                compute_dtype: str = "bf16", nq: int = 0) -> Dict:
    """Rows of each pass and shared-memory bytes of one block, as the
    kernel's ``geometry`` lays them out. The bf16 kernel reads A by
    descriptor, so its buffers cover whole 64-row m-tiles (+2 tap rows);
    the f32 kernel loads A itself and clamps, so its buffers hold their
    rows exactly, except that a swapped tconv (``nq`` time rows, read by
    descriptor) needs x's TF32 hi and lo planes of nq + 2 rows."""
    N, e = q * r, 2 + int(last)
    nqy = (N + e - 1) // r - (-e) // r + 1
    nx, ny, nh = nqy + 2, N + 2 * e, N + 2 * e - 2
    n_o = N + 2 if last else N
    if compute_dtype == "bf16":
        wn_r = _wn(cop, nw)
        rm = max(nx + 2, _tile_rows(nx, _wn(cip, nw)) + 2) | 1
        rx = max(nx, _tile_rows(nqy, _wn(r * cop, nw)) + 2) | 1
        ry = max(ny, _tile_rows(nh, wn_r) + 2) | 1
        rh = max(nh, _tile_rows(n_o, wn_r) + 2) | 1
    else:
        rm, rx, ry, rh = (nx + 2) | 1, max(nx, nq + 2) | 1, ny | 1, nh | 1
    rm = rm if first else 0
    ro = (N + 2) | 1 if last else 0
    kern = _KERNELS[compute_dtype]
    es = kern["esize"]

    def a128(v):
        return -(-v // 128) * 128

    off_y = a128(128 + TC_SLOTS * slot)
    off_h = a128(off_y + cop * ry * es)
    off_m = a128(off_h + cip * rx * es * (2 if nq else 1))
    off_o = a128(max(off_h + cop * rh * es, off_m + cmp * rm * es))
    return {"nqy": nqy, "nx": nx, "nh": nh, "n_o": n_o,
            "smem": a128(off_o + cop * ro * es)}


def _passes(st: Dict) -> List[Dict]:
    """The k=3 passes of a stage, in launch order: input channels, output
    columns, whether it is the tconv, its rows' key in the geometry, the
    columns of a warpgroup's tile and the m-tiles a warpgroup
    accumulates."""
    cip, cop, r, nw = st["cip"], st["cop"], st["r"], st["nw"]
    kern = _KERNELS[st["compute_dtype"]]
    ft = st.get("ft", 1)
    conv = {"tconv": False, "width": nw, "mt": kern["mt"]}
    out = []
    if st["first"]:
        out.append({"name": "in", "cin": st["cmp"], "ncols": cip,
                    "rows": "nx", **conv})
    out.append({"name": "t", "cin": cip, "ncols": r * cop, "tconv": True,
                "rows": "nqy", "width": ft * nw,
                "mt": kern["tconv_mt"][ft], "nq": st.get("nq", 0)})
    out.append({"name": "r", "cin": cop, "ncols": cop, "rows": "nh", **conv})
    out.append({"name": "r", "cin": cop, "ncols": cop, "rows": "n_o",
                **conv})
    return out


#: time rows a swapped f32 tconv may take (``vocoder_tc32.cu::wgmma_ss``)
_SWAP_ROWS = (16, 24, 32, 48, 64)


def _swap_rows(st: Dict, nqy: int) -> int:
    """Time rows N of the swapped f32 tconv for ``nqy`` rows, or 0 where it
    does not apply: the 64-column kernel, 256-column groups that stay on
    one side of the dead-tap boundary, and nqy ≤ 64."""
    ncols, half = st["r"] * st["cop"], (st["r"] // 2) * st["cop"]
    if st["nw"] != 64 or st["r"] < 4 or ncols % 256 or half % 256:
        return 0
    return next((n for n in _SWAP_ROWS if n >= nqy), 0)


def _tconv_blocks(st: Dict) -> List[int]:
    """Column blocks F the f32 tconv's warpgroup tile may take: 1, and 2 or
    4 where the tile (at most 256 columns) divides the columns and, for
    r ≥ 4, its column groups stay on one side of the dead-tap boundary (no
    dead tap is multiplied). A wider tile feeds more columns from each
    fragment but streams larger weight chunks."""
    nw, ncols = st["nw"], st["r"] * st["cop"]
    half = (st["r"] // 2) * st["cop"]
    return [1] + [f for f in (2, 4) if f * nw <= 256 and ncols % (f * nw) == 0
                  and (st["r"] == 2 or half % (_wn(ncols, f * nw) * f * nw) == 0)]


def _chunk_bytes(st: Dict, ps: Dict, kc: int) -> int:
    """Largest weight chunk of a pass at ``kc`` input channels a chunk."""
    kern = _KERNELS[st["compute_dtype"]]
    ng = _wn(ps["ncols"], ps["width"]) * ps["width"]
    half = (st["r"] // 2) * st["cop"]
    taps = max(t1 - t0 for t0, t1 in (
        _group_taps(g0, ng, ps["tconv"], half)
        for g0 in range(0, ps["ncols"], ng)))
    return kern["planes"] * taps * kc * ng * kern["esize"]


def _tc_stage_plan(r: int, c_in: int, c_out: int, c_mel: int, first: bool,
                   last: bool, compute_dtype: str) -> Dict:
    kern = _KERNELS[compute_dtype]
    st = {"r": r, "c_in": c_in, "c_out": c_out, "c_mel": c_mel,
          "first": first, "last": last, "compute_dtype": compute_dtype,
          "cmp": _pad16(c_mel) if first else 0, "cip": _pad16(c_in),
          "cop": _pad16(c_out)}
    st["nw"] = next(w for w in (64, 32, 16)
                    if st["cip"] % w == 0 and st["cop"] % w == 0)
    # the f32 tconv's layouts: a tile of F column blocks, or swapped
    f32 = compute_dtype == "f32"
    layouts = ([(f, False) for f in _tconv_blocks(st)] + [(2, True)]
               if f32 else [(None, False)])
    best = None
    for ft, swap in layouts:
        for q in range(1, 1024 // r + 1):
            if f32:
                st.update(ft=ft, nq=0)
                if swap:
                    st["nq"] = _swap_rows(st, _geometry(st, q)["nqy"])
                    if not st["nq"]:
                        continue
            for cost, kc in _tilings(st, q):
                if best is None or cost <= best[0]:
                    best = (cost, q, kc, ft, st.get("nq"))
    if best is None:
        raise ValueError(f"no tile fits stage r={r} {c_in}->{c_out}")
    _, q, kc, ft, nq = best
    if f32:
        st.update(ft=ft, nq=nq)
    slot = max(_chunk_bytes(st, ps, kc[ps["name"]]) for ps in _passes(st))
    slot = -(-slot // 128) * 128
    st.update(q_tile=q, kc_in=kc.get("in", kern["k"]), kc_t=kc["t"],
              kc_r=kc["r"], slot_bytes=slot,
              smem_bytes=_geometry(st, q, slot)["smem"])
    return st


def _geometry(st: Dict, q: int, slot: int = 0) -> Dict:
    return tc_geometry(st["cmp"], st["cip"], st["cop"], st["r"], st["first"],
                       st["last"], q, st["nw"], slot, st["compute_dtype"],
                       st.get("nq", 0))


def _tilings(st: Dict, q: int):
    """(cost per output frame, chunk channels per pass) of each way the
    stage's kernel can run ``q`` input frames a block; none if the block
    does not fit. The cost is in tensor-core time of a bf16 FLOP."""
    kern = _KERNELS[st["compute_dtype"]]
    f32 = st["compute_dtype"] == "f32"
    nq = st.get("nq", 0)
    # blocks an SM (the kernel's launch bounds): the narrow stages' tiles
    # need fewer registers, and more blocks hide their latencies
    blocks = kern["blocks"][st["nw"]]
    budget = SMEM_MAX // blocks - (1024 if blocks > 1 else 0)
    geo = _geometry(st, q)
    passes = _passes(st)
    wns = [_wn(ps["ncols"], ps["width"]) for ps in passes]
    tiles = [_tile_rows(geo[ps["rows"]], wn) // 64
             for ps, wn in zip(passes, wns)]
    swapped = [bool(nq) and ps["tconv"] for ps in passes]
    if geo["smem"] > budget or any(
            t > ps["mt"] * (3 - wn)
            for t, ps, wn, sw in zip(tiles, passes, wns, swapped) if not sw):
        return
    ngroups = [ps["ncols"] // (wn * ps["width"]) for ps, wn in zip(passes, wns)]
    # MMA work of the padded 64-row tiles (the swapped tconv: nq rows), plus
    # the weights each block streams from L2 (~128 FLOP of tensor-core time
    # a byte)
    work = sum(kern["mma_cost"] * (nq if sw else 64 * t) * ps["cin"]
               * ps["ncols"] * (2 if ps["tconv"] else 3) * 2
               for t, ps, sw in zip(tiles, passes, swapped))
    work += 128 * sum(_chunk_bytes(st, ps, ps["cin"]) * n
                      for ps, n in zip(passes, ngroups))
    kcs_all = [[k for k in range(kern["k"], ps["cin"] + 1, kern["k"])
                if ps["cin"] % k == 0] for ps in passes]
    for kc in _chunk_choices(st, passes, kcs_all, budget - geo["smem"]):
        cost = work
        if f32:
            # plus every register fragment a warpgroup splits, the chunk
            # barriers and the block's activation window in and output out
            for ps, n, t, wn, sw, k in zip(passes, ngroups, tiles, wns,
                                           swapped, kc):
                mh = t if wn == 2 else -(-t // 2)
                taps = 2 if ps["tconv"] and n > 1 else 3
                cost += n * (ps["cin"] // 8 * taps * (0 if sw else mh)
                             * _FRAGMENT_COST + ps["cin"] // k * _CHUNK_COST)
            cost += _BLOCK_COST
        # plus a fixed cost a block, per output frame
        yield (cost + 2e5) / (q * st["r"]), dict(
            zip((ps["name"] for ps in passes), kc))


def _chunk_choices(st: Dict, passes: List[Dict], kcs_all: List[List[int]],
                   room: int):
    """Chunk channels per pass that the weight ring's two slots can take in
    ``room`` bytes of shared memory: for each slot size (at most 64 KB),
    the largest chunk of each pass that fits it, smallest slot first (so
    that, at equal cost, the planner keeps the largest chunks)."""
    for cap in sorted({_chunk_bytes(st, ps, k)
                       for ps, ks in zip(passes, kcs_all) for k in ks}):
        if cap > 64 * 1024 or TC_SLOTS * (-(-cap // 128) * 128) > room:
            break
        kc = [max([k for k in ks if _chunk_bytes(st, ps, k) <= cap],
                  default=None) for ps, ks in zip(passes, kcs_all)]
        if None not in kc:
            yield kc


def tc_plan(rates: Sequence[int], c_mel: int, channels: int,
            compute_dtype: str = "bf16") -> List[Dict]:
    """Per-stage tiling of the tensor-core kernel of ``compute_dtype``:
    padded channels, the warpgroup tile width ``nw``, input frames a block
    ``q_tile``, channels a weight chunk per pass, the weight ring's slot
    bytes and shared-memory bytes."""
    if compute_dtype not in _KERNELS:
        raise ValueError(f"Unknown compute_dtype {compute_dtype!r}")
    plan, cin = [], channels
    for i, r in enumerate(rates):
        plan.append(_tc_stage_plan(int(r), cin, cin // 2, c_mel, i == 0,
                                   i == len(rates) - 1, compute_dtype))
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
    its order: for each column group of ``wn`` warpgroup tiles, for each
    ``kc`` input channels, the group's live taps as [taps][kc/g][cols][g]
    with g = 16 bytes of elements (8 bf16, 4 f32); for f32 the TF32 hi
    plane, then the lo plane."""
    ng = _wn(ps["ncols"], ps["width"]) * ps["width"]
    half = (st["r"] // 2) * st["cop"]
    f32 = st["compute_dtype"] == "f32"
    g = 4 if f32 else 8
    out = []
    for g0 in range(0, ps["ncols"], ng):
        t0, t1 = _group_taps(g0, ng, ps["tconv"], half)
        for k0 in range(0, ps["cin"], kc):
            blk = w3[t0:t1, k0:k0 + kc, g0:g0 + ng]
            blk = (blk.reshape(t1 - t0, kc // g, g, ng)
                   .permute(0, 1, 3, 2).reshape(-1))
            out.append(torch.cat(tf32_split(blk)) if f32 else blk)
    return out


def _tc_pack_stage(packed: Dict, i: int, st: Dict, device) -> Dict:
    """Kernel operands of stage ``i``: the chunk stream (bf16, or f32 TF32
    planes), its byte offsets (int32), padded biases (f32) and output-conv
    weights (in the stream's type)."""
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
    es = _KERNELS[st["compute_dtype"]]["esize"]
    wdt = torch.float32 if st["compute_dtype"] == "f32" else torch.bfloat16
    off = [0]
    for c in chunks:
        off.append(off[-1] + es * c.numel())

    def bias(b, n):
        return F.pad(b.float(), (0, n - b.numel())).to(device).contiguous()

    ops = {
        "w": torch.cat(chunks).to(device=device, dtype=wdt),
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
            device=device, dtype=wdt)
        ops["b_o"] = bias(packed["output_conv"]["b"], 1)
    return ops


#: tensor-core operands per weight set, compute dtype and device, keyed by
#: the id of the input conv's weight tensor and dropped with it
_TC_CACHE: Dict[tuple, tuple] = {}


def _tc_operands(packed: Dict, c_mel: int, device,
                 compute_dtype: str) -> List[Dict]:
    w = packed["input_conv"]["w"]
    key = (id(w), compute_dtype)
    hit = _TC_CACHE.get(key)
    if hit is None or hit[0]() is not w or hit[1] != device:
        rates = [st["tconv"]["rate"] for st in packed["stages"]]
        plan = tc_plan(rates, c_mel, w.shape[1], compute_dtype)
        ops = [(st, _tc_pack_stage(packed, i, st, device))
               for i, st in enumerate(plan)]
        hit = (weakref.ref(w), device, ops)
        _TC_CACHE[key] = hit
        weakref.finalize(w, _TC_CACHE.pop, key, None)
    return hit[2]


@torch.no_grad()
def refresh_operands(packed: Dict) -> None:
    """The tensor-core operands cached for ``packed`` (any compute dtype and
    device) rebuilt from its current weights, into the same tensors: a CUDA
    graph that captured a launch on them replays the new weights."""
    w = packed["input_conv"]["w"]
    for ref, device, ops in list(_TC_CACHE.values()):
        if ref() is not w:
            continue
        for i, (st, old) in enumerate(ops):
            new = _tc_pack_stage(packed, i, st, device)
            for k, v in old.items():
                if isinstance(v, torch.Tensor):
                    v.copy_(new[k])


def _tc_launch(x: torch.Tensor, st: Dict, ops: Dict) -> torch.Tensor:
    """One tensor-core stage launch on the padded layout: x is the f32 mel
    (first) or [B, T, cip] in the compute dtype; returns [B, T·r, cop] in
    the compute dtype or the f32 audio (last)."""
    global LAUNCHES_TC, LAUNCHES_TC32
    from m2tts_tpu_torch.ops.cuda.build import check, load

    f32 = st["compute_dtype"] == "f32"
    B, T = x.shape[:2]
    t_out = T * st["r"]
    out = (torch.empty((B, t_out), dtype=torch.float32, device=x.device)
           if st["last"] else
           torch.empty((B, t_out, st["cop"]),
                       dtype=torch.float32 if f32 else torch.bfloat16,
                       device=x.device))
    lib = load(_KERNELS[st["compute_dtype"]]["lib"])
    fn = lib.m2tts_vocoder_tc32_stage if f32 else lib.m2tts_vocoder_tc_stage
    ptr = lambda k: ops[k].data_ptr() if k in ops else None  # noqa: E731
    err = fn(
        x.data_ptr(), out.data_ptr(), ptr("w"), ptr("off"), ptr("b_in"),
        ptr("b_t"), ptr("b_r1"), ptr("b_r2"), ptr("w_o"), ptr("b_o"),
        B, T, st["c_mel"], st["cmp"], st["cip"], st["cop"], st["r"],
        int(st["first"]), int(st["last"]), st["q_tile"], st["nw"],
        *([st["ft"], st["nq"]] if f32 else []), st["kc_in"], st["kc_t"],
        st["kc_r"], st["slot_bytes"], ops["nchunks"],
        torch.cuda.current_stream(x.device).cuda_stream)
    if f32:
        LAUNCHES_TC32 += 1
    else:
        LAUNCHES_TC += 1
    check(err, f"tensor-core vocoder stage ({st['compute_dtype']}, "
          f"r={st['r']}) launch")
    return out


def _check_plain(x: torch.Tensor, packed: Dict) -> None:
    """The kernels read raw pointers: a DTensor (of a mesh) must come as its
    local tensor."""
    if isinstance(x, DTensor) or isinstance(packed["input_conv"]["w"],
                                            DTensor):
        raise TypeError("the vocoder kernels take plain tensors; pass a "
                        "DTensor's local tensor (DTensor.to_local())")


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

    bf16 runs ``vocoder_tc.cu``, f32 the 3×TF32 ``vocoder_tc32.cu``, one
    launch per stage on the current CUDA stream without synchronising; the
    output and the stage intermediates are allocated with ``torch.empty``.
    """
    _check_plain(mel, packed)
    _check_mel(mel, packed, compute_dtype)
    rates = tuple(int(r) for r in rates)
    if tuple(st["tconv"]["rate"] for st in packed["stages"]) != rates:
        raise ValueError(f"rates {rates} do not match the packed weights")
    if mel.device.type == "cpu":
        return vocoder_mm_forward(mel, packed, compute_dtype)
    _check_device(mel)
    x = mel
    for st, ops in _tc_operands(packed, mel.shape[2], mel.device,
                                compute_dtype):
        x = _tc_launch(x, st, ops)
    return x


def fused_vocoder_stage(x: torch.Tensor, packed: Dict, index: int,
                        compute_dtype: str = "f32") -> torch.Tensor:
    """Stage ``index`` alone, with the input and output of
    ``vocoder_mm_stage``: x is the f32 mel (first stage) or activations
    [B, T, C] in the compute dtype; returns the next activations, or the f32
    audio (last stage)."""
    _check_plain(x, packed)
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
    st, ops = _tc_operands(packed, c_mel, x.device, compute_dtype)[index]
    if not first and st["cip"] != x.shape[2]:
        x = F.pad(x, (0, st["cip"] - x.shape[2])).contiguous()
    out = _tc_launch(x, st, ops)
    return out if last else out[..., :st["c_out"]].contiguous()


def stage_plan(rates: Sequence[int], c_mel: int, channels: int,
               compute_dtype: str = "f32") -> List[Dict]:
    """Per-stage tiling of the kernel ``compute_dtype`` runs (``tc_plan``),
    the keys a reader of a run needs."""
    keys = ("r", "cip", "cop", "nw", "ft", "nq", "q_tile", "kc_in", "kc_t",
            "kc_r", "slot_bytes", "smem_bytes")
    return [{k: st[k] for k in keys if k in st}
            for st in tc_plan(rates, c_mel, channels, compute_dtype)]


def tc_smem_bytes(st: Dict) -> int:
    """Shared-memory bytes of a tensor-core stage as its kernel library
    lays them out (needs the built library); equals ``st['smem_bytes']``."""
    from m2tts_tpu_torch.ops.cuda.build import load

    lib = load(_KERNELS[st["compute_dtype"]]["lib"])
    args = (st["cmp"], st["cip"], st["cop"], st["r"], int(st["first"]),
            int(st["last"]), st["q_tile"], st["nw"], st["slot_bytes"])
    if st["compute_dtype"] == "f32":
        return lib.m2tts_vocoder_tc32_smem(*args, st["nq"])
    return lib.m2tts_vocoder_tc_smem(*args)
