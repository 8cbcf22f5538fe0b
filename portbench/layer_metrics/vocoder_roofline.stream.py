"""The streaming path's vocoder launches (vocoder_tc.cu chunks, vocoder_tc32.cu short path), each bound at its own dtype and shape, over their summed device time, in %."""

from portbench import readers


def read(rec):
    return readers.roofline_pct(rec)
