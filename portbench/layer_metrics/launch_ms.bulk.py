"""Host time a batch call spends before the device (Synthesizer._launch: G2P, packing, the probe's round trip, the enqueue), per call, in ms."""

from portbench import readers


def read(rec):
    return readers.span_ms_per_call(rec, "launch")
