"""Vocoder of the PyTorch port: packed weights, the plain packed-matmul
forward and the ``Vocoder`` module against the JAX packing and both Pallas
kernels (interpret mode), the per-stage plain version, the 3×TF32 split of
the f32 kernel, both tensor-core kernels' tiling and weight chunks, and the
CUDA wrappers' CPU behaviour. The cases that need a card are in
``test_torch_cuda.py``.

Tolerances: f32 atol 3e-5 / rtol 1e-4 (the 3×TF32 emulation too). bf16 (the port's plain version
against the Pallas kernels, both with bf16 matmul inputs, f32 sums and the
same rounding points): max abs 2e-2 and mean abs 1e-3 — the sums run in
another order, so an intermediate may round to the neighbouring bf16 value
(2^-8 relative) and that propagates.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.models import Vocoder as JaxVocoder
from m2tts_tpu.ops import vocoder_mm as jmm
from m2tts_tpu.ops.pallas.vocoder import fused_vocoder_forward as pallas_padded
from m2tts_tpu.ops.pallas.vocoder_packed import (
    fused_vocoder_packed_forward as pallas_packed)
from m2tts_tpu_torch.models.tts_model import M2TTS, Vocoder
from m2tts_tpu_torch.ops import vocoder_mm as tmm
from m2tts_tpu_torch.ops.cuda import build
from m2tts_tpu_torch.ops.cuda import vocoder as cuda_vocoder
from m2tts_tpu_torch.serving.pipeline import Synthesizer
from m2tts_tpu_torch.utils.params import from_flax

torch.set_num_threads(2)

F32 = dict(atol=3e-5, rtol=1e-4)
BF16_MAX, BF16_MEAN = 2e-2, 1e-3


@pytest.fixture(scope="module",
                params=[((4, 4, 2, 2), 64), ((8, 8, 2, 2), 64),
                        ((8, 8, 2, 2), 128)],
                ids=["64x-c64", "256x-c64", "256x-c128"])
def setup(request):
    rates, channels = request.param
    model = JaxVocoder(mel_channels=16, hidden_channels=channels,
                       upsample_rates=rates)
    params = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 16), jnp.float32)))["params"]
    voc = Vocoder(16, channels, 3, rates).eval()
    voc.load_state_dict(from_flax(params), strict=True)
    jpacked = jmm.pack_vocoder_weights(params, rates)
    mel = np.random.default_rng(7).normal(size=(2, 48, 16)).astype(np.float32)
    return rates, voc, jpacked, mel


def _flat(packed):
    out = [packed["input_conv"]["w"], packed["input_conv"]["b"]]
    for st in packed["stages"]:
        out += [st["tconv"]["w"], st["tconv"]["b"], st["res1"]["w"],
                st["res1"]["b"], st["res2"]["w"], st["res2"]["b"]]
    return out + [packed["output_conv"]["w"], packed["output_conv"]["b"]]


def test_packing_equals_jax(setup):
    rates, voc, jpacked, _ = setup
    tpacked = tmm.pack_vocoder_weights(voc)
    for a, b in zip(_flat(jpacked), _flat(tpacked)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for js, ts in zip(jpacked["stages"], tpacked["stages"]):
        assert (js["tconv"]["rate"], js["tconv"]["cout"]) == \
            (ts["tconv"]["rate"], ts["tconv"]["cout"])


@pytest.mark.parametrize("rate", [2, 4, 8])
def test_pack_tconv_matches_jax(rate):
    w = np.random.default_rng(rate).normal(size=(6, 4, 2 * rate)).astype(np.float32)
    b = np.arange(4, dtype=np.float32)
    ref = jmm.pack_tconv(jnp.asarray(w), jnp.asarray(b), rate)
    out = tmm.pack_tconv(torch.from_numpy(w), torch.from_numpy(b), rate)
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(ref["w"]))
    # the zero tap blocks the fused kernel skips
    W = out["w"].numpy()
    for j in range(rate):
        cols = W[:, j * 4:(j + 1) * 4]
        dead = cols[12:18] if j < rate // 2 else cols[0:6]
        assert not dead.any()


def test_plain_and_module_equal_pallas_f32(setup):
    rates, voc, jpacked, mel = setup
    tpacked = tmm.pack_vocoder_weights(voc)
    ref_packed = np.asarray(pallas_packed(jnp.asarray(mel), jpacked, rates,
                                          tile=16, interpret=True))
    ref_padded = np.asarray(pallas_padded(jnp.asarray(mel), jpacked, rates,
                                          tile=16, interpret=True))
    with torch.no_grad():
        plain = tmm.vocoder_mm_forward(torch.from_numpy(mel), tpacked).numpy()
        module = voc(torch.from_numpy(mel))[..., 0].numpy()
    for out in (plain, module):
        np.testing.assert_allclose(out, ref_packed, **F32)
        np.testing.assert_allclose(out, ref_padded, **F32)


def test_3xtf32_emulation_equals_pallas_f32(setup):
    """The f32 kernel's arithmetic on the CPU: every stage product as the
    three TF32 products of ``tf32_split``'s planes, summed in f32, holds
    the f32 bar against the Pallas kernel. (It cannot show the tensor
    cores' own accumulation order; the card tests do.)"""
    rates, voc, jpacked, mel = setup
    tpacked = tmm.pack_vocoder_weights(voc)
    ref = np.asarray(pallas_packed(jnp.asarray(mel), jpacked, rates,
                                   tile=16, interpret=True))

    def mm(x, w, dt):
        assert dt == torch.float32
        return cuda_vocoder.matmul_3xtf32(x.float(), w.float())

    with mock.patch.object(tmm, "_mm", mm):
        out = tmm.vocoder_mm_forward(torch.from_numpy(mel), tpacked).numpy()
    np.testing.assert_allclose(out, ref, **F32)
    # one TF32 product alone does not hold the bar: the split is needed
    with mock.patch.object(tmm, "_mm", lambda x, w, dt: (
            cuda_vocoder.tf32_split(x)[0] @ cuda_vocoder.tf32_split(w)[0])):
        one = tmm.vocoder_mm_forward(torch.from_numpy(mel), tpacked).numpy()
    assert not np.allclose(one, ref, **F32)


@pytest.mark.parametrize("rounding", ["rna", "trunc"])
def test_tf32_split_holds_each_value(rounding):
    x = torch.from_numpy(np.random.default_rng(5).normal(
        scale=3.0, size=4096).astype(np.float32))
    x[:4] = torch.tensor([0.0, -0.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    hi, lo = cuda_vocoder.tf32_split(x, rounding)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    if rounding == "rna":
        assert not (lo.view(torch.int32) & 0x1FFF).any()
        assert ((hi + lo - x).abs() <= 2.0 ** -22 * x.abs()).all()
        # a tie rounds away from zero, as cvt.rna.tf32.f32
        assert hi[2].item() == 1.0 + 2.0 ** -10
        assert hi[3].item() == -hi[2].item()
    else:
        # hi is x cut to TF32 (|x - hi| < 2^-10 |x|), lo the exact rest
        assert torch.equal(hi + lo, x)
        assert ((lo.abs() < 2.0 ** -10 * x.abs()) | (x == 0)).all()
        assert hi[2].item() == 1.0


def test_plain_bf16_equals_pallas_bf16(setup):
    rates, voc, jpacked, mel = setup
    tpacked = tmm.pack_vocoder_weights(voc, "bf16")
    plain = tmm.vocoder_mm_forward(torch.from_numpy(mel), tpacked,
                                   "bf16").numpy()
    assert plain.dtype == np.float32
    for kernel in (pallas_packed, pallas_padded):
        ref = np.asarray(kernel(jnp.asarray(mel), jpacked, rates, tile=16,
                                interpret=True, compute_dtype="bf16"))
        err = np.abs(plain - ref)
        assert err.max() < BF16_MAX and err.mean() < BF16_MEAN


@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 3), (2, 48)], ids=["1x3", "2x48"])
def test_stages_chain_to_forward(setup, cd, shape):
    """Chaining ``vocoder_mm_stage`` is ``vocoder_mm_forward``, exactly."""
    rates, voc, _, _ = setup
    packed = tmm.pack_vocoder_weights(voc, cd)
    mel = torch.from_numpy(np.random.default_rng(3).normal(
        size=(*shape, 16)).astype(np.float32))
    x, n = mel, len(rates)
    for i, st in enumerate(packed["stages"]):
        x = tmm.vocoder_mm_stage(
            x, st, tmm.DTYPES[cd],
            first=packed["input_conv"] if i == 0 else None,
            last=packed["output_conv"] if i == n - 1 else None)
        if i < n - 1:
            assert x.dtype == tmm.DTYPES[cd]
            assert x.shape == (shape[0], shape[1] * int(np.prod(rates[:i + 1])),
                               st["tconv"]["cout"])
    torch.testing.assert_close(x, tmm.vocoder_mm_forward(mel, packed, cd),
                               rtol=0, atol=0)


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_wrapper_on_cpu_takes_plain_path(setup, cd):
    rates, voc, _, mel = setup
    packed = tmm.pack_vocoder_weights(voc, cd)
    before = (cuda_vocoder.LAUNCHES_TC, cuda_vocoder.LAUNCHES_TC32)
    out = cuda_vocoder.fused_vocoder_forward(torch.from_numpy(mel), packed,
                                             rates, cd)
    np.testing.assert_array_equal(
        out.numpy(),
        tmm.vocoder_mm_forward(torch.from_numpy(mel), packed, cd).numpy())
    x = torch.from_numpy(mel)
    for i in range(len(rates)):
        x = cuda_vocoder.fused_vocoder_stage(x, packed, i, cd)
    np.testing.assert_array_equal(x.numpy(), out.numpy())
    assert (cuda_vocoder.LAUNCHES_TC, cuda_vocoder.LAUNCHES_TC32) == before


@pytest.mark.parametrize("cd", ["bf16", "f32"])
@pytest.mark.parametrize("rates,c_mel,channels",
                         [((8, 8, 2, 2), 80, 256), ((4, 4, 2, 2), 16, 64),
                          ((8, 8, 2, 2), 16, 128), ((2, 2), 5, 24),
                          ((8, 8, 2, 2), 80, 512), ((8, 8, 2, 2), 16, 192)],
                         ids=["flagship", "64x-c64", "256x-c128", "odd-c",
                              "flagship-xl", "256x-c192"])
def test_tc_plan_fits_the_card(rates, c_mel, channels, cd):
    """Every stage's tiling, of the bf16 and of the f32 kernel, fits
    Hopper's shared memory (per block, at the blocks an SM the kernel's
    launch bounds ask for) and the warpgroups' accumulators."""
    kern = cuda_vocoder._KERNELS[cd]
    for st in cuda_vocoder.tc_plan(rates, c_mel, channels, cd):
        assert st["compute_dtype"] == cd
        assert st["cip"] % 16 == st["cop"] % 16 == st["cmp"] % 16 == 0
        assert st["cip"] % st["nw"] == st["cop"] % st["nw"] == 0
        assert st["smem_bytes"] * kern["blocks"][st["nw"]] \
            <= cuda_vocoder.SMEM_MAX
        assert st["slot_bytes"] % 128 == 0
        geo = cuda_vocoder.tc_geometry(
            st["cmp"], st["cip"], st["cop"], st["r"], st["first"],
            st["last"], st["q_tile"], st["nw"], st["slot_bytes"], cd,
            st.get("nq", 0))
        assert geo["smem"] == st["smem_bytes"]
        kcs = {"in": st["kc_in"], "t": st["kc_t"], "r": st["kc_r"]}
        for ps in cuda_vocoder._passes(st):
            kc = kcs[ps["name"]]
            assert ps["cin"] % kc == 0 and kc % kern["k"] == 0
            assert cuda_vocoder._chunk_bytes(st, ps, kc) <= st["slot_bytes"]
            assert ps["ncols"] % ps["width"] == 0 and ps["width"] <= 256
            wn = cuda_vocoder._wn(ps["ncols"], ps["width"])
            tiles = cuda_vocoder._tile_rows(geo[ps["rows"]], wn) // 64
            if ps["tconv"] and ps["nq"]:  # the swapped tconv: rows on N
                assert geo["nqy"] <= ps["nq"] and ps["nq"] % 8 == 0
                assert ps["ncols"] % 256 == 0 and st["nw"] == 64
            else:
                assert tiles <= ps["mt"] * (3 - wn)


@pytest.mark.parametrize("cd", ["bf16", "f32"])
def test_tc_chunks_rebuild_the_weights(setup, cd):
    """The chunk stream a tensor-core kernel copies holds every packed
    weight at the place the kernel reads it, and nothing else but zeros.
    For f32 each chunk is a TF32 hi plane and a lo plane (low 13 mantissa
    bits zero in both) whose sum is the weight within 2^-22 relative."""
    rates, voc, _, _ = setup
    packed = tmm.pack_vocoder_weights(voc, cd)
    plan = cuda_vocoder.tc_plan(rates, 16,
                                voc.input_conv.conv.weight.shape[0], cd)
    f32 = cd == "f32"
    g, es = (4, 4) if f32 else (8, 2)
    for i, st in enumerate(plan):
        ops = cuda_vocoder._tc_pack_stage(packed, i, st, "cpu")
        w, off = ops["w"].float(), ops["off"].tolist()
        assert ops["w"].dtype == (torch.float32 if f32 else torch.bfloat16)
        assert off[-1] == es * w.numel() and len(off) == ops["nchunks"] + 1
        if f32:
            assert not (w.view(torch.int32) & 0x1FFF).any()
        c, nw = 0, st["nw"]
        kcs = {"in": st["kc_in"], "t": st["kc_t"], "r": st["kc_r"]}
        stage = packed["stages"][i]
        mats = [stage["tconv"]["w"], stage["res1"]["w"], stage["res2"]["w"]]
        if st["first"]:
            mats.insert(0, packed["input_conv"]["w"])
        for ps, ref in zip(cuda_vocoder._passes(st), mats):
            # rebuild [3, K, ncols] as the kernel addresses it
            kc = kcs[ps["name"]]
            ng = cuda_vocoder._wn(ps["ncols"], ps["width"]) * ps["width"]
            half = (st["r"] // 2) * st["cop"]
            got = torch.zeros(3, ps["cin"], ps["ncols"])
            for g0 in range(0, ps["ncols"], ng):
                t0, t1 = cuda_vocoder._group_taps(g0, ng, ps["tconv"], half)
                for k0 in range(0, ps["cin"], kc):
                    blk = w[off[c] // es:off[c + 1] // es]
                    if f32:  # hi plane + lo plane
                        blk = blk[:blk.numel() // 2] + blk[blk.numel() // 2:]
                    got[t0:t1, k0:k0 + kc, g0:g0 + ng] = blk.reshape(
                        t1 - t0, kc // g, ng, g).permute(0, 1, 3, 2).reshape(
                        t1 - t0, kc, ng)
                    c += 1
            cin, cols = ref.shape[0] // 3, ref.shape[1]
            ref3 = ref.float().reshape(3, cin, cols)
            pad = got.clone()
            if ps["tconv"]:
                r, cout = st["r"], st["c_out"]
                got = got.reshape(3, ps["cin"], r, st["cop"])[:, :cin, :, :cout]
                pad.reshape(3, ps["cin"], r, st["cop"])[:, :cin, :, :cout] = 0
                ref3 = ref3.reshape(3, cin, r, cout)
            else:
                got = got[:, :cin, :cols]
                pad[:, :cin, :cols] = 0
            if f32:
                assert ((got - ref3).abs() <= 2.0 ** -22 * ref3.abs()).all()
            else:
                torch.testing.assert_close(got, ref3, rtol=0, atol=0)
            assert not pad.any()  # the padding is zero
        assert c == ops["nchunks"]


def test_wrapper_rejects_bad_input(setup):
    rates, voc, _, mel = setup
    packed = tmm.pack_vocoder_weights(voc)
    with pytest.raises(ValueError):
        cuda_vocoder.fused_vocoder_forward(torch.from_numpy(mel[..., :8]),
                                           packed, rates)
    with pytest.raises(ValueError):
        cuda_vocoder.fused_vocoder_forward(torch.from_numpy(mel).double(),
                                           packed, rates)
    with pytest.raises(ValueError):
        cuda_vocoder.fused_vocoder_forward(torch.from_numpy(mel), packed,
                                           rates[:-1])


def test_kernels_unavailable_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert build.kernels_available() is False


def test_cuda_backend_on_cpu_raises():
    model = M2TTS(hidden_dim=16, mel_channels=8, vocoder_channels=16,
                  text_encoder_layers=1, decoder_layers=1)
    with pytest.raises(ValueError):
        Synthesizer(model, vocoder_backend="cuda", device="cpu")
