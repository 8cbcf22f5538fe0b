"""HTTP server of the PyTorch port (``serving/server.py``), in-process on
``127.0.0.1:0`` with the Synthesizer on the CPU, route by route as
``tests/test_serve.py`` and ``tests/test_reload.py`` hold
``scripts/serve.py``: WAV payloads equal the port's own calls exactly and
the JAX package's within ±1 LSB; the 400s and 404s; HTTP/1.1 chunked
streaming, parsed frame by frame; a mid-stream error that ends the body;
μ-law; the batchers behind ``--dynamic-batch``; ``/reload`` from a real
port checkpoint; the four WAV helpers byte-equal to ``scripts/serve.py``'s;
and ``python -m m2tts_tpu_torch.serving.server`` started as a process.
Every thread is a daemon and every request has a timeout."""

import base64
import copy
import http.client
import io
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import wave
from functools import partial
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.models import M2TTS as JaxM2TTS
from m2tts_tpu.serving.pipeline import Synthesizer as JaxSynthesizer
from m2tts_tpu.serving.streaming import \
    StreamingSynthesizer as JaxStreamingSynthesizer
from m2tts_tpu_torch.models.tts_model import M2TTS
from m2tts_tpu_torch.ops.audio_codec import (MULAW_DECODE_TABLE,
                                             mulaw_encode_np)
from m2tts_tpu_torch.serving import server as tserver
from m2tts_tpu_torch.serving import streaming as tstreaming
from m2tts_tpu_torch.serving.pipeline import Synthesizer, from_checkpoint
from m2tts_tpu_torch.serving.streaming import StreamingSynthesizer
from m2tts_tpu_torch.utils.checkpoint import CheckpointManager
from m2tts_tpu_torch.utils.params import from_flax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
KW = dict(hidden_dim=32, mel_channels=16, vocoder_channels=32,
          text_encoder_layers=1, decoder_layers=1)
MODEL_CFG = {"text_encoder": {"hidden_dim": 32, "num_layers": 1},
             "decoder": {"mel_channels": 16, "num_layers": 1},
             "vocoder": {"hidden_channels": 32}}
BUCKETS = dict(text_buckets=(32,), frame_buckets=(128,), batch_buckets=(1, 2))
STREAM_KW = dict(chunk_frames=16, max_frames=128, text_bucket=32)
TIMEOUT = 120
SCALE = 8.0


def _flax_params(seed):
    jm = JaxM2TTS(**KW)
    return jm, jax.device_get(jax.jit(partial(
        jm.init, max_frames=16, run_vocoder=True))(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))


@pytest.fixture(scope="module")
def models():
    jm, params = _flax_params(0)
    tm = M2TTS(**KW)
    tm.load_state_dict(from_flax(params), strict=True)
    return jm, params, tm.eval()


def _synth(models):
    """A Synthesizer over its own copy of the weights (/reload swaps them
    in place)."""
    return Synthesizer(copy.deepcopy(models[2]), device="cpu", **BUCKETS)


class _Server:
    """make_handler on a ThreadingHTTPServer in a daemon thread."""

    def __init__(self, synth, **kw):
        self.synth = synth
        self.httpd = ThreadingHTTPServer(
            ("127.0.0.1", 0),
            tserver.make_handler(synth, tserver.device_info(synth),
                                 stream_chunk_frames=16, **kw))
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=TIMEOUT)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def server(models):
    s = _Server(_synth(models))
    try:
        yield s
    finally:
        s.close()


def _post(url, obj=None, data=None):
    req = urllib.request.Request(
        url, data=data if data is not None else json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=TIMEOUT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _pcm_of_wav(body):
    with wave.open(io.BytesIO(body)) as f:
        assert f.getframerate() == 22050 and f.getnchannels() == 1
        return np.frombuffer(f.readframes(f.getnframes()), "<i2")


def _parse_mulaw_wav(body):
    """(sample rate, μ-law payload) of the hand-rolled G.711 WAV."""
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    assert body[12:16] == b"fmt " and struct.unpack("<I", body[16:20])[0] == 18
    tag, ch, sr, br, ba, bits, cb = struct.unpack("<HHIIHHH", body[20:38])
    assert (tag, ch, bits, br, ba, cb) == (7, 1, 8, sr, 1, 0)
    assert body[38:42] == b"fact" and body[50:54] == b"data"
    n = struct.unpack("<I", body[54:58])[0]
    data = body[58:]
    return sr, (data[:n] if n != 0xFFFFFFFF else data)


def _close_pcm(a, b, lsb=1):
    assert a.shape == b.shape
    if a.size:
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= lsb


def _local_stream_pcm(streamer, text, scale=SCALE):
    audio = np.concatenate(list(streamer.stream(text, scale)))
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)


def _raw_chunked(port, path, obj):
    """POST over a raw socket; returns (status line, headers, [chunk
    payloads]) with the HTTP/1.1 chunk framing parsed by hand."""
    body = json.dumps(obj).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as s:
        s.sendall(f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
                  .encode() + body)
        f = s.makefile("rb")
        status = f.readline().decode().strip()
        headers = {}
        while True:
            line = f.readline().decode().strip()
            if not line:
                break
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        chunks = []
        while True:
            size = int(f.readline().decode().strip(), 16)
            data = f.read(size)
            assert len(data) == size and f.read(2) == b"\r\n"
            if size == 0:
                break
            chunks.append(data)
        assert f.read() == b""  # nothing after the terminator
    return status, headers, chunks


# -- routes -------------------------------------------------------------------

def test_healthz(server):
    status, body = _get(server.url + "/healthz")
    assert status == 200 and body["status"] == "ok"
    assert body["device"] == "cpu" and "backend" not in body
    assert body["sample_rate"] == 22050
    assert (body["vocoder_backend"], body["compute_dtype"]) == ("torch", "f32")


def test_synthesize_returns_wav_of_the_synthesizer(server, models):
    status, ctype, body = _post(server.url + "/synthesize",
                                {"text": "hello server",
                                 "duration_scale": SCALE})
    assert status == 200 and ctype == "audio/wav"
    pcm = _pcm_of_wav(body)
    assert pcm.size > 0
    np.testing.assert_array_equal(
        pcm, server.synth.synthesize("hello server", SCALE)["audio_pcm"])
    ref = JaxSynthesizer(models[0], models[1], **BUCKETS).synthesize(
        "hello server", SCALE)["audio_pcm"]
    _close_pcm(pcm, ref)


def test_synthesize_batch(server):
    texts = ["one", "two longer text"]
    status, _, body = _post(server.url + "/synthesize_batch",
                            {"texts": texts, "duration_scale": SCALE})
    assert status == 200
    results = json.loads(body)["results"]
    direct = server.synth.synthesize_batch(texts, SCALE)
    assert len(results) == 2
    for r, d in zip(results, direct):
        pcm = _pcm_of_wav(base64.b64decode(r["audio_b64"]))
        np.testing.assert_array_equal(pcm, d["audio_pcm"])
        assert r["seconds"] == pytest.approx(len(pcm) / 22050)
    assert results[1]["seconds"] > 0


@pytest.mark.parametrize("path,obj,field", [
    ("/synthesize", {"nope": 1}, "text"),
    ("/synthesize", {"text": 5}, "text"),
    ("/synthesize", {"text": "x", "duration_scale": "fast"},
     "duration_scale"),
    ("/synthesize", {"text": "x", "format": "opus"}, "format"),
    ("/synthesize_stream", {"text": ""}, "text"),
    ("/synthesize_batch", {"texts": []}, "texts"),
    ("/synthesize_batch", {"texts": ["ok", ""]}, "texts"),
    ("/reload", {}, "checkpoint"),
    ("/synthesize", [1, 2], "object"),
], ids=["no-text", "text-type", "scale", "format", "stream-text",
        "batch-empty", "batch-blank", "reload-no-dir", "not-object"])
def test_bad_requests_are_400(server, path, obj, field):
    status, ctype, body = _post(server.url + path, obj)
    assert status == 400 and ctype == "application/json"
    assert field in json.loads(body)["error"]


@pytest.mark.parametrize("data", [b"not json", b""], ids=["junk", "empty"])
def test_bad_body_is_400(server, data):
    assert _post(server.url + "/synthesize", data=data)[0] == 400


def test_unknown_routes_404(server):
    assert _post(server.url + "/nope", {"x": 1})[0] == 404
    assert _get(server.url + "/nope")[0] == 404


def test_long_text_auto_chunks(server):
    text = "the quick brown fox jumps over the lazy dog. " * 6
    status, ctype, body = _post(server.url + "/synthesize", {"text": text})
    assert status == 200 and ctype == "audio/wav"
    np.testing.assert_array_equal(
        _pcm_of_wav(body), server.synth.synthesize_long(text)["audio_pcm"])
    status, _, body = _post(server.url + "/synthesize_batch",
                            {"texts": [text, "short"]})
    assert status == 200 and len(json.loads(body)["results"]) == 2


def test_synthesize_stream_chunked_wav(server, models):
    text = "hello streaming world"
    status, headers, chunks = _raw_chunked(
        server.port, "/synthesize_stream",
        {"text": text, "duration_scale": SCALE})
    assert status == "HTTP/1.1 200 OK"
    assert headers["transfer-encoding"] == "chunked"
    assert headers["content-type"] == "audio/wav"
    assert chunks[0] == tserver.wav_stream_header(22050)
    assert len(chunks) >= 3  # the header, then one HTTP chunk per audio chunk
    pcm = np.frombuffer(b"".join(chunks[1:]), "<i2")
    ss = StreamingSynthesizer(models[2], **STREAM_KW, device="cpu")
    np.testing.assert_array_equal(pcm, _local_stream_pcm(ss, text))
    jss = JaxStreamingSynthesizer(models[0], models[1], **STREAM_KW)
    _close_pcm(pcm, _local_stream_pcm(jss, text))


def test_stream_is_http11(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                      timeout=TIMEOUT)
    try:
        conn.request("POST", "/synthesize_stream",
                     body=json.dumps({"text": "version check"}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.version == 11
        assert resp.headers.get("Transfer-Encoding") == "chunked"
        assert resp.read()[:4] == b"RIFF"
    finally:
        conn.close()


def test_stream_midstream_error_ends_the_body(models, monkeypatch):
    def boom_stream(self, text, duration_scale=1.0, gap_ms=120.0):
        yield np.zeros(64, np.float32)
        raise RuntimeError("simulated mid-stream device failure")

    monkeypatch.setattr(tstreaming.StreamingSynthesizer, "stream",
                        boom_stream)
    srv = _Server(_synth(models))
    try:
        status, headers, chunks = _raw_chunked(
            srv.port, "/synthesize_stream", {"text": "will fail"})
        # one clean, short chunked WAV: the header and the first chunk,
        # then the terminator; no second response on the connection
        assert status == "HTTP/1.1 200 OK"
        assert len(chunks) == 2 and chunks[0][:4] == b"RIFF"
        assert chunks[1] == np.zeros(64, np.int16).tobytes()
        status2, _, body2 = _post(srv.url + "/synthesize",
                                  {"text": "still alive"})
        assert status2 == 200 and body2[:4] == b"RIFF"
    finally:
        srv.close()


def test_synthesize_mulaw_wav(server):
    smu, _, bodymu = _post(server.url + "/synthesize",
                           {"text": "mu law", "format": "mulaw",
                            "duration_scale": SCALE})
    s16, _, body16 = _post(server.url + "/synthesize",
                           {"text": "mu law", "duration_scale": SCALE})
    assert smu == s16 == 200
    sr, payload = _parse_mulaw_wav(bodymu)
    assert sr == 22050
    direct = server.synth.synthesize("mu law", SCALE, pcm_format="mulaw")
    assert payload == direct["audio_mulaw"].tobytes()
    assert payload == mulaw_encode_np(_pcm_of_wav(body16)).tobytes()


def test_synthesize_batch_mulaw(server):
    texts = ["hello mu law world", "two longer text here"]
    status, _, body = _post(server.url + "/synthesize_batch",
                            {"texts": texts, "format": "mulaw",
                             "duration_scale": SCALE})
    assert status == 200
    results = json.loads(body)["results"]
    direct = server.synth.synthesize_batch(texts, SCALE, pcm_format="mulaw")
    assert any(r["seconds"] > 0 for r in results)
    for r, d in zip(results, direct):
        sr, payload = _parse_mulaw_wav(base64.b64decode(r["audio_b64"]))
        assert sr == 22050 and payload == d["audio_mulaw"].tobytes()
        assert r["seconds"] == pytest.approx(len(payload) / 22050)


def test_stream_mulaw_matches_pcm_stream(server):
    req = {"text": "stream mu", "duration_scale": SCALE}
    pcm = np.frombuffer(_post(server.url + "/synthesize_stream", req)[2][44:],
                        "<i2")
    sr, payload = _parse_mulaw_wav(
        _post(server.url + "/synthesize_stream", {**req, "format": "mulaw"})[2])
    assert sr == 22050 and payload == mulaw_encode_np(pcm).tobytes()
    err = MULAW_DECODE_TABLE[np.frombuffer(payload, np.uint8)].astype(
        np.int32) - pcm
    assert np.abs(err).max(initial=0) <= 1024  # the companding bound


# -- the batchers behind --dynamic-batch --------------------------------------

def test_dynamic_batch_routes(models):
    srv = _Server(_synth(models), dynamic_batch_wait_ms=150.0)
    texts = ["hello world", "streaming in batches", "the quick brown fox"]
    bodies = [None] * (2 * len(texts))

    def post(i):
        path = "/synthesize" if i < len(texts) else "/synthesize_stream"
        bodies[i] = _post(srv.url + path, {"text": texts[i % len(texts)],
                                           "duration_scale": SCALE})

    threads = [threading.Thread(target=post, args=(i,), daemon=True)
               for i in range(len(bodies))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        _, health = _get(srv.url + "/healthz")
    finally:
        srv.close()
    assert health["batched_requests_served"] == len(texts)
    assert health["batches_run"] < len(texts)
    assert health["streams_served"] == len(texts)
    assert 0 < health["stream_chunk_dispatches"] \
        < health["stream_chunks_emitted"]
    ss = StreamingSynthesizer(models[2], **STREAM_KW, device="cpu")
    for i, text in enumerate(texts):
        status, _, body = bodies[i]
        assert status == 200
        # the batcher's calls may take another batch shape: ±1 LSB
        _close_pcm(_pcm_of_wav(body),
                   srv.synth.synthesize(text, SCALE)["audio_pcm"])
        status, _, body = bodies[len(texts) + i]
        assert status == 200 and body[:4] == b"RIFF"
        _close_pcm(np.frombuffer(body[44:], "<i2"),
                   _local_stream_pcm(ss, text))


def test_healthz_lists_the_work_counters(models):
    """The Synthesizer's counters from the start (the pinned copy's two
    staying 0 on the CPU), the StreamBatcher's admission and device-lock
    counters beside its chunk counters once the batcher exists."""
    srv = _Server(_synth(models), dynamic_batch_wait_ms=5.0)
    try:
        _, before = _get(srv.url + "/healthz")
        status, _, _ = _post(srv.url + "/synthesize_batch",
                             {"texts": ["hello world", "a second text"],
                              "duration_scale": SCALE})
        assert status == 200
        status, _, _ = _post(srv.url + "/synthesize_stream",
                             {"text": "the quick brown fox",
                              "duration_scale": SCALE})
        assert status == 200
        _, after = _get(srv.url + "/healthz")
    finally:
        srv.close()
    synth = srv.synth
    assert {k: before[k] for k in ("synth_calls", "synth_frames_run",
                                   "synth_frames_served",
                                   "synth_truncated", "synth_pinned_fetches",
                                   "synth_fetched_bytes")} == \
        dict(synth_calls=0, synth_frames_run=0, synth_frames_served=0,
             synth_truncated=0, synth_pinned_fetches=0,
             synth_fetched_bytes=0)
    assert "stream_admitted" not in before
    assert (after["synth_calls"], after["synth_frames_run"],
            after["synth_frames_served"], after["synth_truncated"],
            after["synth_pinned_fetches"], after["synth_fetched_bytes"]) == \
        (synth.calls, synth.frames_run, synth.frames_served,
         synth.truncated, 0, 0)
    assert 0 < after["synth_frames_served"] <= after["synth_frames_run"]
    assert (after["stream_admitted"], after["stream_admit_passes"]) == (1, 1)
    assert after["stream_lock_acquires"] >= 1 + \
        after["stream_chunk_dispatches"]
    assert after["stream_lock_wait_ns"] >= 0


def test_warmup_streams_runs_the_stream_batcher_buckets(models, capsys):
    srv = _Server(_synth(models), dynamic_batch_wait_ms=5.0,
                  warmup_streams=True)
    try:
        assert "warmed 8 streaming calls" in capsys.readouterr().out
        _, health = _get(srv.url + "/healthz")
        assert health["streams_served"] == 0  # the batcher already exists
    finally:
        srv.close()


# -- /reload ------------------------------------------------------------------

def test_reload_from_a_port_checkpoint(models, tmp_path):
    jm, params1 = _flax_params(1)
    CheckpointManager(tmp_path / "ckpt").save(
        7, {"generator": from_flax(params1), "step": 7},
        config={"model": MODEL_CFG})
    CheckpointManager(tmp_path / "back").save(
        1, {"generator": models[2].state_dict()}, config={"model": MODEL_CFG})
    srv = _Server(_synth(models), dynamic_batch_wait_ms=20.0)
    text = "before the rollout"
    req = {"text": text, "duration_scale": SCALE}
    try:
        _, _, wav_a = _post(srv.url + "/synthesize", req)
        _, _, stream_a = _post(srv.url + "/synthesize_stream", req)
        status, _, body = _post(srv.url + "/reload",
                                {"checkpoint": str(tmp_path / "ckpt")})
        assert status == 200
        assert json.loads(body) == {"status": "reloaded", "step": 7,
                                    "checkpoint": str(tmp_path / "ckpt")}
        _, _, wav_b = _post(srv.url + "/synthesize", req)
        _, _, stream_b = _post(srv.url + "/synthesize_stream", req)
        for bad in ({"checkpoint": str(tmp_path / "nowhere")},
                    {"checkpoint": str(tmp_path / "ckpt"), "step": "best"},
                    {"checkpoint": str(tmp_path / "ckpt"), "step": 3}):
            assert _post(srv.url + "/reload", bad)[0] == 400
        # and back: the first weights serve the first audio again
        assert _post(srv.url + "/reload",
                     {"checkpoint": str(tmp_path / "back")})[0] == 200
        assert _post(srv.url + "/synthesize", req)[2] == wav_a
    finally:
        srv.close()
    assert wav_a != wav_b and stream_a != stream_b
    fresh = from_checkpoint(tmp_path / "ckpt", device="cpu", **BUCKETS)
    np.testing.assert_array_equal(_pcm_of_wav(wav_b),
                                  fresh.synthesize(text, SCALE)["audio_pcm"])
    _close_pcm(_pcm_of_wav(wav_b), JaxSynthesizer(jm, params1, **BUCKETS)
               .synthesize(text, SCALE)["audio_pcm"])
    ss = StreamingSynthesizer(fresh.model, **STREAM_KW, device="cpu")
    _close_pcm(np.frombuffer(stream_b[44:], "<i2"),
               _local_stream_pcm(ss, text))


def test_reload_rejects_another_architecture(models, tmp_path):
    other = M2TTS(**{**KW, "hidden_dim": 64})
    CheckpointManager(tmp_path / "ckpt").save(
        1, {"generator": other.state_dict()}, config={"model": MODEL_CFG})
    srv = _Server(_synth(models))
    try:
        before = _post(srv.url + "/synthesize", {"text": "still serving"})[2]
        status, _, body = _post(srv.url + "/reload",
                                {"checkpoint": str(tmp_path / "ckpt")})
        assert status == 400 and "mismatch" in json.loads(body)["error"]
        after = _post(srv.url + "/synthesize", {"text": "still serving"})[2]
        assert before == after  # the serving weights are unchanged
    finally:
        srv.close()


# -- WAV helpers and the entry point -----------------------------------------

@pytest.fixture(scope="module")
def jax_serve():
    sys.path.insert(0, str(ROOT))
    from scripts import serve

    return serve


@pytest.mark.parametrize("sample_rate", [8000, 22050, 48000])
def test_wav_helpers_match_scripts_serve(jax_serve, sample_rate):
    rng = np.random.default_rng(sample_rate)
    pcm = rng.integers(-32768, 32768, size=1001).astype(np.int16)
    mu = mulaw_encode_np(pcm).tobytes()
    assert tserver.wav_bytes(pcm, sample_rate) == \
        jax_serve.wav_bytes(pcm, sample_rate)
    assert tserver.wav_stream_header(sample_rate) == \
        jax_serve.wav_stream_header(sample_rate)
    assert tserver.wav_bytes_mulaw(mu, sample_rate) == \
        jax_serve.wav_bytes_mulaw(mu, sample_rate)
    assert tserver.wav_bytes_mulaw(mu, sample_rate, 7) == \
        jax_serve.wav_bytes_mulaw(mu, sample_rate, 7)
    assert tserver.wav_stream_header_mulaw(sample_rate) == \
        jax_serve.wav_stream_header_mulaw(sample_rate)
    assert len(tserver.wav_stream_header(sample_rate)) == 44


def test_flags_and_cuda_default():
    args = tserver.parse_args(["--random-init"])
    assert (args.device, args.vocoder_backend, args.compute_dtype) == \
        ("cuda", "auto", "auto")
    assert (args.host, args.port, args.stream_chunk_frames,
            args.batch_wait_ms) == ("127.0.0.1", 8080, 64, 10.0)
    assert not (args.dynamic_batch or args.warmup or args.warmup_all)
    with pytest.raises(SystemExit):
        tserver.build_synthesizer(tserver.parse_args(["--device", "cpu"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tserver.build_synthesizer(args)
    synth = tserver.build_synthesizer(tserver.parse_args(
        ["--random-init", "--device", "cpu",
         "--config", str(ROOT / "configs" / "stage1_poc.yaml")]))
    assert synth.model.mel_channels == 64 and synth.device.type == "cpu"


def test_torch_checkpoint_flag_serves_the_pt(tmp_path):
    """``--torch-checkpoint`` serves a reference-layout ``.pt``: /synthesize
    answers the PCM of ``from_torch_checkpoint`` on it exactly, and the JAX
    package's ``from_torch_checkpoint`` within ±1 LSB."""
    from m2tts_tpu.serving import pipeline as jpipeline
    from m2tts_tpu_torch.models.tts_model import init_params
    from m2tts_tpu_torch.serving.pipeline import from_torch_checkpoint
    from m2tts_tpu_torch.utils.params import to_flax
    from m2tts_tpu_torch.utils.torch_compat import reference_state_dict

    model = init_params(M2TTS(**KW, duration_norm="batch"),
                        torch.Generator().manual_seed(5), "cpu")
    path = tmp_path / "reference.pt"
    torch.save({"model_state_dict": reference_state_dict(
        to_flax(model.state_dict()), 1, 1, 4),
        "config": {"model": MODEL_CFG}}, path)
    args = tserver.parse_args(["--torch-checkpoint", str(path),
                               "--device", "cpu"])
    synth = tserver.build_synthesizer(args)
    assert synth.model.duration_predictor.predictor.block1.norm_kind == \
        "batch"
    srv = _Server(synth)
    try:
        status, ctype, body = _post(srv.url + "/synthesize",
                                    {"text": "hello reference",
                                     "duration_scale": SCALE})
    finally:
        srv.close()
    assert status == 200 and ctype == "audio/wav"
    pcm = _pcm_of_wav(body)
    assert pcm.size > 0
    np.testing.assert_array_equal(pcm, from_torch_checkpoint(
        path, device="cpu").synthesize("hello reference", SCALE)["audio_pcm"])
    _close_pcm(pcm, jpipeline.from_torch_checkpoint(str(path)).synthesize(
        "hello reference", SCALE)["audio_pcm"])


def test_module_entry_point_serves(tmp_path):
    """``python -m m2tts_tpu_torch.serving.server`` on the CPU answers
    /healthz (the flagship model, seeded random weights)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "m2tts_tpu_torch.serving.server",
         "--random-init", "--device", "cpu", "--port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        line = ""
        for line in proc.stdout:
            if line.startswith("serving on"):
                break
        url = line.split()[2]
        status, body = _get(url + "/healthz")
        assert status == 200 and body["device"] == "cpu"
        assert body["vocoder_backend"] == "torch"
    finally:
        proc.terminate()
        proc.wait(timeout=60)
