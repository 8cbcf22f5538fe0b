"""The streaming path's share of the card's bf16 peak while it works: FLOPs of the audio streamed, counted on the reference at each utterance's own lengths, over the union of the batcher's device calls (admission passes, chunk dispatches, short-path calls, each until its result is on the host), in %. Under a fixed offered rate the window's work is fixed, so the share is taken over the time the calls hold, which a faster call shortens."""

from portbench import readers


def read(rec):
    return readers.mfu_pct(rec, over="calls_s")
