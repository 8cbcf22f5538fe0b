"""95th percentile of the time from a stream's scheduled send to the return of StreamBatcher.stream (the coalescing window and the batched acoustic pass), in ms."""

from portbench import readers


def read(rec):
    return readers.p95(rec.get("admit_ms", []))
