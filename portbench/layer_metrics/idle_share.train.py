"""Share of the traced GAN-training window in which no device operation ran, in %."""

from portbench import readers


def read(rec):
    return readers.idle_pct(rec)
