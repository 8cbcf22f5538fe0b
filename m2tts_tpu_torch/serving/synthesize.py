"""Text → waveform synthesis CLI of the PyTorch port.

Counterpart of ``scripts/synthesize.py``, flag for flag:

    python -m m2tts_tpu_torch.serving.synthesize --text "Hello." \\
        --checkpoint <dir> [--output out.wav] [--device cpu]

  --checkpoint        a checkpoint dir written by ``utils.checkpoint``
                      (``<dir>/<step>/state.pt`` + ``config.json``;
                      ``tools/orbax_to_torch.py`` converts the JAX
                      package's); ``--step`` picks an int, ``best`` or the
                      latest
  --torch-checkpoint  a reference PyTorch ``.pt`` checkpoint
  --batch-file        one WAV per line (``<stem>_<i:03d><suffix>``), in
                      batches of the largest batch bucket; a line over the
                      phoneme budget sends the batch through the
                      sentence-chunked long-form path
  --streaming         chunked streaming of one ``--text``: the WAV equals
                      the batch path's; prints first-chunk latency and RTF
  --griffin-lim       skip the vocoder: the synthesized mel inverted on the
                      host (``AudioProcessor.mel_to_audio``)

Runs on CUDA (the vocoder kernels under ``--vocoder-backend auto``) unless
``--device cpu``. ``main(argv)`` returns 0.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def parse_step(step):
    """--step: an int, 'best' (the best-validation pin), or None (latest)."""
    if step in (None, "", "latest"):
        return None
    return step if step == "best" else int(step)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="m2tts synthesis (PyTorch/CUDA port)")
    p.add_argument("--text", type=str, default=None, help="Text to synthesize")
    p.add_argument("--batch-file", type=str, default=None,
                   help="File with one utterance per line")
    p.add_argument("--step", type=str, default=None,
                   help="checkpoint step to load: an int, 'best', or latest "
                        "(default)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint directory (utils.checkpoint format)")
    p.add_argument("--torch-checkpoint", type=str, default=None,
                   help="reference PyTorch .pt checkpoint to convert")
    p.add_argument("--output", type=str, default="output.wav")
    p.add_argument("--duration-scale", type=float, default=1.0)
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--griffin-lim", action="store_true",
                   help="invert mel with Griffin-Lim instead of the vocoder")
    p.add_argument("--vocoder-backend", type=str, default="auto",
                   choices=("auto", "torch", "mm", "cuda"),
                   help="vocoder implementation (auto: the CUDA kernels on "
                        "a CUDA device, the Vocoder module on the CPU)")
    p.add_argument("--compute-dtype", type=str, default="auto",
                   choices=("auto", "bf16", "f32"),
                   help="synthesis compute dtype (auto = bf16 on CUDA)")
    p.add_argument("--streaming", action="store_true",
                   help="chunked streaming synthesis (single --text only): "
                        "prints first-chunk latency; the WAV equals the "
                        "batch path's")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    if args.text is None and args.batch_file is None:
        p.error("one of --text / --batch-file is required")
    if args.checkpoint is None and args.torch_checkpoint is None:
        p.error("one of --checkpoint / --torch-checkpoint is required")

    from m2tts_tpu_torch.frontend.audio import AudioProcessor, save_wav
    from m2tts_tpu_torch.serving import pipeline

    kwargs = dict(vocoder_backend=args.vocoder_backend,
                  compute_dtype=args.compute_dtype, device=args.device)
    if args.checkpoint:
        synth = pipeline.from_checkpoint(
            args.checkpoint, step=parse_step(args.step), **kwargs)
    else:
        synth = pipeline.from_torch_checkpoint(args.torch_checkpoint,
                                               **kwargs)

    if args.text is not None:
        texts = [args.text]
    else:
        with open(args.batch_file) as f:
            texts = [line.strip() for line in f if line.strip()]

    if args.streaming:
        if len(texts) != 1 or args.griffin_lim:
            p.error("--streaming requires a single --text and no "
                    "--griffin-lim")
        from m2tts_tpu_torch.serving.streaming import StreamingSynthesizer

        ss = StreamingSynthesizer(synth.model,
                                  vocoder_backend=synth.vocoder_backend,
                                  compute_dtype=synth.compute_dtype,
                                  sample_rate=synth.sample_rate,
                                  device=synth.device)
        t0 = time.perf_counter()
        chunks = []
        first_ms = None
        for chunk in ss.stream(texts[0], args.duration_scale):
            if first_ms is None:
                first_ms = (time.perf_counter() - t0) * 1000.0
            chunks.append(chunk)
        elapsed = time.perf_counter() - t0
        audio = np.concatenate(chunks) if chunks else np.zeros(0, "float32")
        save_wav(audio, args.output, args.sample_rate)
        dur = len(audio) / args.sample_rate
        print(f"streamed {len(chunks)} chunks, {dur:.2f}s audio -> "
              f"{args.output}")
        print(f"first-chunk latency {first_ms:.1f} ms (incl. kernel build "
              f"on first call); total {elapsed:.3f}s "
              f"(RTF {elapsed / max(dur, 1e-9):.4f})")
        return 0

    t0 = time.perf_counter()
    budget = synth.phoneme_budget() - 2
    n_phon = lambda t: len(synth.text_processor.text_to_phonemes(t))  # noqa: E731
    if not args.griffin_lim and any(n_phon(t) > budget for t in texts):
        # over one bucket: the sentence-chunked long-form path (otherwise
        # the frontend truncates to the bucket), for batch-file lines too
        results = synth.synthesize_batch_long(texts, args.duration_scale)
        n_over = sum(1 for t in texts if n_phon(t) > budget)
        n_chunks = sum(len(r["chunks"]) for r in results)
        print(f"long-form: {n_over}/{len(texts)} text(s) over the "
              f"{budget}-phoneme budget; split into {n_chunks} chunks")
    else:
        # bucket-sized groups, so a batch file with more lines than the
        # largest batch bucket still yields one WAV per line
        max_b = max(synth.batch_buckets)
        results = []
        for i in range(0, len(texts), max_b):
            results.extend(pipeline.own_rows(synth.synthesize_batch(
                texts[i:i + max_b], args.duration_scale,
                want_mel=args.griffin_lim)))
    elapsed = time.perf_counter() - t0

    out = Path(args.output)
    total_audio_sec = 0.0
    for i, (text, res) in enumerate(zip(texts, results)):
        if args.griffin_lim:
            ap = AudioProcessor(sample_rate=args.sample_rate,
                                n_mels=res["mel"].shape[-1])
            audio = ap.mel_to_audio(res["mel"].T)
        else:
            audio = res["audio"]
        path = out if len(texts) == 1 else out.with_name(
            f"{out.stem}_{i:03d}{out.suffix}")
        save_wav(audio, path, args.sample_rate)
        dur = len(audio) / args.sample_rate
        total_audio_sec += dur
        print(f"[{i}] {dur:.2f}s  {path}  ({text[:50]!r})")

    rtf = elapsed / max(total_audio_sec, 1e-9)
    print(f"Generated {total_audio_sec:.2f}s audio in {elapsed:.3f}s "
          f"(RTF {rtf:.4f}, incl. kernel build on first call)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
