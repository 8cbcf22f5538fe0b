"""HTTP synthesis server over the port's bucketed pipeline.

Counterpart of ``scripts/serve.py``, with the same routes, status codes
and payloads. Stdlib only (``ThreadingHTTPServer`` + json):

  GET  /healthz            → {"status": "ok", device, vocoder_backend, ...}
  POST /synthesize         → audio/wav
        body: {"text": str, "duration_scale": float = 1.0,
               "format": "pcm16"|"mulaw"}
        "mulaw" sends G.711 μ-law WAV (format tag 7), companded on the
        device, at one byte a sample. Every route takes the same "format".
  POST /synthesize_batch   → {"results": [{"audio_b64": wav bytes, base64,
        body: {"texts": [str], ...}     "seconds": float}, ...]}
  POST /synthesize_stream  → audio/wav, Transfer-Encoding: chunked; each
        body: {"text": str, ...}       audio chunk is sent as the chunked
        vocoder makes it (a streaming WAV with unknown-length headers);
        long texts stream sentence by sentence.
  POST /reload             → swaps the serving weights in place from a
        body: {"checkpoint": dir,      checkpoint written by
               "step": int|"best"}     ``utils.checkpoint.CheckpointManager``

Every device call goes through one lock. With ``--dynamic-batch``,
concurrent /synthesize requests are coalesced by a ``DynamicBatcher`` and
concurrent streams share batched calls through a ``StreamBatcher``.

    python -m m2tts_tpu_torch.serving.server --random-init --port 8080
    python -m m2tts_tpu_torch.serving.server --random-init --device cpu
    python -m m2tts_tpu_torch.serving.server --checkpoint <dir> --dynamic-batch

``--random-init`` without ``--config`` serves the flagship model
(``FLAGSHIP_MODEL``) with seeded random weights; ``--config`` reads a YAML
config (needs PyYAML).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import queue
import struct
import sys
import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from m2tts_tpu_torch.ops.audio_codec import mulaw_encode_np
from m2tts_tpu_torch.serving import pipeline
from m2tts_tpu_torch.serving.batcher import DynamicBatcher
from m2tts_tpu_torch.serving.stream_batcher import StreamBatcher
from m2tts_tpu_torch.serving.streaming import StreamingSynthesizer
from m2tts_tpu_torch.utils.checkpoint import load_for_inference
from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL, load_config

logger = logging.getLogger(__name__)

_UNKNOWN = 0xFFFFFFFF


def wav_bytes(pcm16: np.ndarray, sample_rate: int) -> bytes:
    """PCM16 mono WAV."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm16.tobytes())
    return buf.getvalue()


def wav_stream_header(sample_rate: int) -> bytes:
    """44-byte PCM16 mono WAV header with unknown (maximal) lengths, the
    streaming-WAV convention: players read until the stream ends."""
    return (b"RIFF" + struct.pack("<I", _UNKNOWN) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                          sample_rate * 2, 2, 16)
            + b"data" + struct.pack("<I", _UNKNOWN))


def wav_bytes_mulaw(data, sample_rate: int,
                    n_samples: Optional[int] = None) -> bytes:
    """G.711 μ-law mono WAV (format tag 7): the 18-byte fmt chunk
    (cbSize 0) and a fact chunk with the sample count, which a non-PCM WAV
    needs and stdlib ``wave`` does not write."""
    data = bytes(data)
    if n_samples is None:
        n_samples = len(data)
    body = (b"WAVEfmt "
            + struct.pack("<IHHIIHHH", 18, 7, 1, sample_rate,
                          sample_rate, 1, 8, 0)
            + b"fact" + struct.pack("<II", 4, n_samples)
            + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def wav_stream_header_mulaw(sample_rate: int) -> bytes:
    """μ-law streaming WAV header (unknown lengths, as wav_stream_header)."""
    return (b"RIFF" + struct.pack("<I", _UNKNOWN) + b"WAVEfmt "
            + struct.pack("<IHHIIHHH", 18, 7, 1, sample_rate,
                          sample_rate, 1, 8, 0)
            + b"fact" + struct.pack("<II", 4, _UNKNOWN)
            + b"data" + struct.pack("<I", _UNKNOWN))


def _mulaw_bytes_of(r) -> bytes:
    """μ-law payload of a result: the device-companded bytes when the
    μ-law path made them, a host table encode otherwise (the long-form
    path joins float audio on the host)."""
    if "audio_mulaw" in r:
        return r["audio_mulaw"].tobytes()
    return mulaw_encode_np(r["audio_pcm"]).tobytes()


def make_handler(synth, info, stream_chunk_frames: int = 64,
                 dynamic_batch_wait_ms: Optional[float] = None,
                 warmup_streams: bool = False):
    """The request handler class over ``synth`` (a ``Synthesizer``);
    ``info`` is merged into /healthz. ``dynamic_batch_wait_ms`` (not None)
    turns on the batchers with that straggler window."""
    lock = threading.Lock()
    batcher = None
    if dynamic_batch_wait_ms is not None:
        batcher = DynamicBatcher(synth, lock=lock,
                                 max_wait_ms=dynamic_batch_wait_ms)
    streamer = {}  # built on the first /synthesize_stream, dropped on reload
    # two concurrent first requests must not each build one (the loser's
    # worker threads would leak)
    streamer_mu = threading.Lock()

    def _get_streamer_locked():
        if "ss" not in streamer:
            streamer["ss"] = StreamingSynthesizer(
                synth.model, chunk_frames=stream_chunk_frames,
                max_frames=max(synth.frame_buckets),
                text_bucket=max(synth.text_buckets),
                vocoder_backend=synth.vocoder_backend,
                compute_dtype=synth.compute_dtype,
                sample_rate=synth.sample_rate, device=synth.device)
        return streamer["ss"]

    def get_streamer():
        with streamer_mu:
            return _get_streamer_locked()

    def get_stream_batcher():
        with streamer_mu:
            if "sb" not in streamer:
                streamer["sb"] = StreamBatcher(
                    _get_streamer_locked(), lock=lock,
                    max_wait_ms=dynamic_batch_wait_ms)
            return streamer["sb"]

    if warmup_streams and dynamic_batch_wait_ms is not None:
        n = get_stream_batcher().warmup()
        print(f"warmed {n} streaming calls", flush=True)

    class Handler(BaseHTTPRequestHandler):
        # chunked transfer encoding is HTTP/1.1; on an HTTP/1.0 status line
        # clients would read the chunk framing as body bytes
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _wav(self, body: bytes):
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self):
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0:
                raise ValueError("empty request body")
            return json.loads(self.rfile.read(n))

        def do_GET(self):
            if self.path != "/healthz":
                self._json(404, {"error": f"no route {self.path}"})
                return
            stats = {}
            if batcher is not None:
                stats["batched_requests_served"] = batcher.requests_served
                stats["batches_run"] = batcher.batches_run
            sb = streamer.get("sb")
            if sb is not None:
                stats["streams_served"] = sb.streams_served
                stats["stream_chunk_dispatches"] = sb.chunk_dispatches
                stats["stream_chunks_emitted"] = sb.chunks_emitted
            self._json(200, {"status": "ok", **info, **stats})

        def do_POST(self):
            try:
                req = self._read_body()
            except (ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request body: {e}"})
                return
            if not isinstance(req, dict):
                self._json(400, {"error": "request body must be a JSON "
                                          "object"})
                return
            try:
                try:
                    scale = float(req.get("duration_scale", 1.0))
                except (TypeError, ValueError):
                    self._json(400, {"error": "'duration_scale' must be a "
                                              "number"})
                    return
                fmt = req.get("format", "pcm16")
                if fmt not in ("pcm16", "mulaw"):
                    self._json(400, {"error": "'format' must be 'pcm16' or "
                                              "'mulaw'"})
                    return
                mulaw = fmt == "mulaw"
                if self.path == "/synthesize":
                    self._synthesize(req, scale, mulaw)
                elif self.path == "/synthesize_stream":
                    self._synthesize_stream(req, scale, mulaw)
                elif self.path == "/reload":
                    self._reload(req)
                elif self.path == "/synthesize_batch":
                    self._synthesize_batch(req, scale, mulaw)
                else:
                    self._json(404, {"error": f"no route {self.path}"})
            except Exception as e:  # keep the server alive
                logger.exception("request to %s failed", self.path)
                self._json(500, {"error": str(e)})

        def _wav_of(self, r, mulaw: bool) -> bytes:
            if mulaw:
                return wav_bytes_mulaw(_mulaw_bytes_of(r), synth.sample_rate)
            return wav_bytes(r["audio_pcm"], synth.sample_rate)

        def _synthesize(self, req, scale: float, mulaw: bool):
            text = req.get("text")
            if not text or not isinstance(text, str):
                self._json(400, {"error": "'text' (string) required"})
                return
            pcm_format = "mulaw" if mulaw else "int16"
            n = len(synth.text_processor.text_to_phonemes(text))
            if n > synth.phoneme_budget() - 2:
                with lock:  # needs splitting, not batching
                    r = synth.synthesize_long(text, scale)
            elif batcher is not None:
                r = batcher.submit(text, scale, pcm_format=pcm_format)
            else:
                with lock:
                    r = synth.synthesize_batch([text], scale,
                                               pcm_format=pcm_format)[0]
            self._wav(self._wav_of(r, mulaw))

        def _synthesize_batch(self, req, scale: float, mulaw: bool):
            texts = req.get("texts")
            if (not isinstance(texts, list) or not texts
                    or not all(isinstance(t, str) and t for t in texts)):
                self._json(400, {"error": "'texts' (non-empty list of "
                                          "strings) required"})
                return
            budget = synth.phoneme_budget() - 2
            over = any(len(synth.text_processor.text_to_phonemes(t)) > budget
                       for t in texts)
            with lock:
                # over-budget texts would be cut short by the plain batch
                # path
                results = (synth.synthesize_batch_long(texts, scale) if over
                           else synth.synthesize_batch(
                               texts, scale,
                               pcm_format="mulaw" if mulaw else "int16"))
            out = [{"audio_b64": base64.b64encode(
                        self._wav_of(r, mulaw)).decode(),
                    "seconds": len(r["audio_pcm"] if "audio_pcm" in r
                                   else r["audio_mulaw"])
                    / synth.sample_rate}
                   for r in results]
            self._json(200, {"results": out})

        def _synthesize_stream(self, req, scale: float, mulaw: bool):
            text = req.get("text")
            if not text or not isinstance(text, str):
                self._json(400, {"error": "'text' (string) required"})
                return
            # Chunks are made on the device apart from the client's write
            # loop, so a slow reader never holds the device lock: without
            # the batchers a producer thread makes the whole utterance into
            # an unbounded queue; with them the StreamBatcher's scheduler
            # is that producer.
            chunk_q: "queue.SimpleQueue" = queue.SimpleQueue()
            if batcher is not None:
                # raises before the headers on a failed admission (→ 500)
                chunks = get_stream_batcher().stream(text, scale)

                def produce():
                    try:
                        for c in chunks:
                            chunk_q.put(("chunk", c))
                        chunk_q.put(("done", None))
                    except Exception as e:
                        chunk_q.put(("error", e))
            else:
                def produce():
                    try:
                        with torch.inference_mode(), lock:
                            for c in get_streamer().stream(text, scale):
                                chunk_q.put(("chunk", c))
                        chunk_q.put(("done", None))
                    except Exception as e:
                        chunk_q.put(("error", e))

            threading.Thread(target=produce, daemon=True,
                             name="stream-producer").start()
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def write_chunk(b: bytes):
                self.wfile.write(f"{len(b):X}\r\n".encode())
                self.wfile.write(b)
                self.wfile.write(b"\r\n")

            # the headers are out, so a failure from here on can only end
            # the chunked body early; a JSON 500 would append a second
            # response to this connection
            try:
                write_chunk(wav_stream_header_mulaw(synth.sample_rate)
                            if mulaw else wav_stream_header(synth.sample_rate))
                while True:
                    kind, payload = chunk_q.get()
                    if kind == "chunk":
                        pcm = (np.clip(payload, -1.0, 1.0)
                               * 32767.0).astype(np.int16)
                        write_chunk(mulaw_encode_np(pcm).tobytes()
                                    if mulaw else pcm.tobytes())
                    elif kind == "error":
                        logger.error("stream synthesis failed: %r", payload)
                        break
                    else:
                        break
                self.wfile.write(b"0\r\n\r\n")
            except OSError as e:  # the client went away mid-stream
                logger.warning("stream client dropped: %r", e)
                self.close_connection = True

        def _reload(self, req):
            # the weights are swapped in place; the streaming objects are
            # rebuilt on the next stream (streams in flight finish on the
            # weights they started with)
            ck = req.get("checkpoint")
            if not ck or not isinstance(ck, str):
                self._json(400, {"error": "'checkpoint' (string dir) "
                                          "required"})
                return
            try:
                state_dict, _cfg, step = load_for_inference(ck,
                                                             req.get("step"))
                with lock:
                    synth.swap_params(state_dict)
            except (ValueError, FileNotFoundError) as e:
                self._json(400, {"error": str(e)})
                return
            with streamer_mu:
                old_sb = streamer.pop("sb", None)
                streamer.pop("ss", None)
            if old_sb is not None:
                old_sb.close()
            self._json(200, {"status": "reloaded", "checkpoint": ck,
                             "step": step})

    return Handler


def build_synthesizer(args):
    """The ``Synthesizer`` the flags ask for."""
    kwargs = {"compute_dtype": args.compute_dtype,
              "vocoder_backend": args.vocoder_backend, "device": args.device}
    if args.checkpoint:
        return pipeline.from_checkpoint(args.checkpoint, **kwargs)
    if args.torch_checkpoint:
        return pipeline.from_torch_checkpoint(args.torch_checkpoint, **kwargs)
    if args.random_init:
        config = (load_config(args.config) if args.config
                  else {"model": FLAGSHIP_MODEL})
        return pipeline.from_config(config, **kwargs)
    raise SystemExit("one of --checkpoint / --torch-checkpoint / "
                     "--random-init is required")


def device_info(synth) -> dict:
    """What /healthz reports of the device, as torch names it."""
    info = {"device": str(synth.device)}
    if synth.device.type == "cuda":
        info["device_name"] = torch.cuda.get_device_name(synth.device)
    return {**info, "vocoder_backend": synth.vocoder_backend,
            "compute_dtype": synth.compute_dtype,
            "sample_rate": synth.sample_rate}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="m2tts HTTP synthesis server (PyTorch/CUDA port)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint dir written by CheckpointManager")
    p.add_argument("--torch-checkpoint", type=str, default=None,
                   help="reference PyTorch checkpoint (.pt) of the original "
                        "m2-tts layout")
    p.add_argument("--random-init", action="store_true",
                   help="untrained model with seeded random weights")
    p.add_argument("--config", type=str, default=None,
                   help="YAML config for --random-init (default: the "
                        "flagship model)")
    p.add_argument("--vocoder-backend", type=str, default="auto",
                   choices=("auto", "cuda", "mm", "torch"))
    p.add_argument("--compute-dtype", type=str, default="auto",
                   choices=("auto", "bf16", "f32"),
                   help="synthesis compute dtype (auto = bf16 on CUDA)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--stream-chunk-frames", type=int, default=64,
                   help="mel frames per /synthesize_stream vocoder chunk")
    p.add_argument("--dynamic-batch", action="store_true",
                   help="coalesce concurrent /synthesize requests and "
                        "streams into batched calls (window: "
                        "--batch-wait-ms)")
    p.add_argument("--batch-wait-ms", type=float, default=10.0,
                   help="straggler window for --dynamic-batch")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--warmup", action="store_true",
                   help="run the single-stream buckets before serving")
    p.add_argument("--warmup-all", action="store_true",
                   help="run every reachable (batch x text x frame) bucket "
                        "before serving")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    synth = build_synthesizer(args)
    if args.warmup or args.warmup_all:
        n = synth.warmup(full=args.warmup_all)
        print(f"warmed {n} serving shapes", flush=True)
    info = device_info(synth)
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(synth, info,
                     stream_chunk_frames=args.stream_chunk_frames,
                     dynamic_batch_wait_ms=(args.batch_wait_ms
                                            if args.dynamic_batch else None),
                     warmup_streams=args.warmup or args.warmup_all))
    print(f"serving on http://{args.host}:{server.server_address[1]}  {info}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
