"""The whole GAN step's share of the card's bf16 peak: FLOPs of the steps completed in the window (counted on the reference at each step's bucket, ``work.GanStepFlops``), over the window, in %."""

from portbench import readers


def read(rec):
    return readers.mfu_pct(rec)
