"""Chunks the StreamBatcher's scheduler hands out per batched vocoder call
over the window (its counters chunks_emitted / chunk_dispatches)."""


def read(rec):
    n = rec.get("chunk_dispatches")
    return rec["chunks_emitted"] / n if n else None
