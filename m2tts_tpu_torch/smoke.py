"""Pipeline smoke suite of the PyTorch port (prints PASS/FAIL per part).

    python -m m2tts_tpu_torch.smoke [--cpu] [--quick]

Counterpart of ``scripts/test_pipeline.py``: the same seven parts, by the
same names and in the same order (device setup, text processing, phoneme
dictionary, model forward, inference + WAV, dataset batching, config
loading), on the port's modules. It runs on the CUDA device and raises
without one; ``--cpu`` runs every part on the CPU instead. (JAX's ``--cpu``
also stands up a virtual 8-device mesh for its sharded paths; the port's
mesh is one process per device, so here ``--cpu`` only picks the device.)
``--quick`` skips inference + WAV.

Exit code 0 iff every part passes. The tests under ``tests/`` are the real
test surface; this is the quick operator-facing health check.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


def _part(name):
    def deco(fn):
        fn._part_name = name
        return fn
    return deco


@_part("device setup")
def test_device(device: torch.device):
    from m2tts_tpu_torch.utils.device import get_device_info, setup_devices

    devices = setup_devices(device.type)
    info = get_device_info()
    assert len(devices) >= 1
    print(f"    device={device.type} devices={len(devices)} "
          f"host_mem_gb={info.get('host_memory_total_gb', 0):.1f}")


@_part("text processing")
def test_text(device: torch.device):
    from m2tts_tpu_torch.frontend.text import TextProcessor

    tp = TextProcessor()
    out = tp.process("Hello world, this is a test!", max_length=64)
    ids, length = out["phoneme_ids"], out["length"]
    assert len(ids) == 64 and 0 < length <= 64
    assert all(0 <= i < 256 for i in ids)
    print(f"    {length} phonemes (padded to 64)")


@_part("phoneme dictionary")
def test_phoneme_dict(device: torch.device):
    from m2tts_tpu_torch.frontend.text import (PHONEME_TO_ID, PHONEMES,
                                               write_phoneme_dict)

    assert len(PHONEMES) == len(set(PHONEMES)) == len(PHONEME_TO_ID)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "phonemes.tsv"
        write_phoneme_dict(path)
        lines = path.read_text().strip().splitlines()
        assert len(lines) == len(PHONEMES)
    print(f"    {len(PHONEMES)} phonemes")


@_part("model forward")
def test_model_forward(device: torch.device):
    from m2tts_tpu_torch.models.tts_model import build_model, init_params
    from m2tts_tpu_torch.utils.config import load_config

    cfg = load_config(REPO / "configs" / "stage1_poc.yaml")
    model = init_params(build_model(cfg.model),
                        torch.Generator().manual_seed(0), device)
    ids = torch.zeros((2, 32), dtype=torch.int32, device=device)
    ids[:, :10] = 5
    lengths = torch.tensor([10, 8], dtype=torch.int32, device=device)
    with torch.no_grad():
        mel = model(ids, lengths, max_frames=128)["mel_output"]
    assert mel.shape[0] == 2 and mel.shape[2] == cfg.model.decoder.mel_channels
    assert bool(torch.isfinite(mel).all())
    print(f"    mel {tuple(mel.shape)} finite")


@_part("inference + WAV")
def test_inference_wav(device: torch.device):
    import numpy as np

    from m2tts_tpu_torch.frontend.audio import save_wav
    from m2tts_tpu_torch.serving import pipeline
    from m2tts_tpu_torch.utils.config import load_config

    cfg = load_config(REPO / "configs" / "stage1_poc.yaml")
    synth = pipeline.from_config(cfg, seed=0, device=device)
    text = "Testing speech synthesis end to end."
    # untrained durations are arbitrary (torch's seeded init is not JAX's):
    # scale them to about one second of frames
    enc = synth.text_processor.process(text)
    raw = int(synth.predict_frames([enc["phoneme_ids"]], [enc["length"]],
                                   1000.0)[0])
    assert raw > 0, "the duration predictor gives no frames"
    scale = 1000.0 * (synth.sample_rate // synth.hop_length) / raw
    t0 = time.perf_counter()
    results = synth.synthesize_batch([text], duration_scale=scale)
    audio = np.asarray(results[0]["audio"], np.float32)
    assert audio.ndim == 1 and audio.size > 0 and np.isfinite(audio).all()
    with tempfile.TemporaryDirectory() as d:
        save_wav(audio, Path(d) / "smoke.wav", 22050)
    print(f"    {audio.size} samples in {time.perf_counter() - t0:.2f}s "
          f"({synth.vocoder_backend} vocoder, {synth.compute_dtype})")


@_part("dataset batching")
def test_dataset(device: torch.device):
    from m2tts_tpu_torch.data.dataset import DummyDataset, make_batches

    ds = DummyDataset(size=16)
    buckets = [(64, 256), (128, 512)]
    batches = list(make_batches(ds, batch_size=4, buckets=buckets, seed=0))
    assert batches, "no batches produced"
    b = batches[0]
    assert b["phoneme_ids"].shape[0] == 4
    assert b["mel"].shape[1] in (256, 512)
    print(f"    {len(batches)} batches, first mel {tuple(b['mel'].shape)}")


@_part("config loading")
def test_config(device: torch.device):
    from m2tts_tpu_torch.utils.config import load_config

    names = ("stage1_poc.yaml", "stage2_quality.yaml", "flagship_tpu.yaml",
             "flagship_xl.yaml")
    for name in names:
        cfg = load_config(REPO / "configs" / name)
        for group in ("model", "training", "data", "system", "paths"):
            assert group in cfg, f"{name} missing group {group}"
    print(f"    {len(names)} configs x 5 groups ok")


ALL_PARTS = [test_device, test_text, test_phoneme_dict, test_model_forward,
             test_inference_wav, test_dataset, test_config]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="pipeline smoke suite")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    p.add_argument("--quick", action="store_true",
                   help="skip the inference+WAV part")
    args = p.parse_args(argv)

    from m2tts_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    parts = [f for f in ALL_PARTS
             if not (args.quick and f is test_inference_wav)]
    failed = []
    for fn in parts:
        name = fn._part_name
        print(f"[ .. ] {name}")
        try:
            fn(device)
            print(f"[ OK ] {name}")
        except Exception:  # a part's failure is reported, the suite goes on
            traceback.print_exc()
            print(f"[FAIL] {name}")
            failed.append(name)

    print(f"\n{len(parts) - len(failed)}/{len(parts)} parts passed"
          + (f"; FAILED: {', '.join(failed)}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
