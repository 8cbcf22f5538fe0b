"""The batch path's vocoder launches (vocoder_tc.cu): summed roofline bounds at each launch's shape over their summed device time, in %."""

from portbench import readers


def read(rec):
    return readers.roofline_pct(rec)
