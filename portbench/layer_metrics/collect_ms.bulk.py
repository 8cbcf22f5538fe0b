"""Host time a batch call spends after the device (Synthesizer._collect with _fetch: the wait for the device, the PCM copy, the trim, the float32 copies), per call, in ms."""

from portbench import readers


def read(rec):
    return readers.span_ms_per_call(rec, "collect")
