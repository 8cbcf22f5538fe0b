"""PyTorch/CUDA port of m2tts-tpu: the serving path (text → int16 PCM) with
hand-written Hopper kernels. Mirrors the layout of ``m2tts_tpu``; imports
nothing from it."""

__version__ = "0.1.0"
