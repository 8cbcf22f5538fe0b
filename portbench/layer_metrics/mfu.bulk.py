"""The whole batch call's share of the card's bf16 peak: FLOPs of the audio returned, counted on the reference at each utterance's own lengths, over the window, in %."""

from portbench import readers


def read(rec):
    return readers.mfu_pct(rec)
