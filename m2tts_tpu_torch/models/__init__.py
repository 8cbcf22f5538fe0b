"""Acoustic model and vocoder modules."""

from m2tts_tpu_torch.models.tts_model import (  # noqa: F401
    M2TTS,
    Vocoder,
    build_model,
    init_params,
)
