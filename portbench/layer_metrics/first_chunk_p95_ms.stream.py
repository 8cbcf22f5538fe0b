"""95th percentile over every request sent in the window of the time from its scheduled send to its first chunk in the client's hands (a failed request counts as missing), in ms."""


def read(rec):
    return rec.get("first_chunk_p95_ms")
