"""Device-resident dataset staging: every batch of an epoch is copied to the
device once, then replayed in a fresh shuffled order each epoch.

A copy of ``m2tts_tpu/data/device_cache.py``. Incremental: each host batch
is collated, copied and released before the next is built, so host memory
holds one batch, and the budget counts the device tensors' bytes as they
accumulate (a bf16 mel counts half), falling back to streaming (None) when
the corpus does not fit.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def stage_on_device(host_batches: Iterable[Dict[str, Any]],
                    put_fn: Callable[[Dict[str, Any]], Dict[str, Any]],
                    max_bytes: float,
                    ) -> Optional[List[Dict[str, Any]]]:
    """Place every batch on device; None when the budget would be exceeded.

    ``put_fn`` does any per-batch host prep (dtype casts, resampling) and
    the device copy. Byte accounting uses the device tensors' nbytes, so
    transfer-dtype halving is reflected exactly.
    """
    staged: List[Dict[str, Any]] = []
    total = 0
    for hb in host_batches:
        db = put_fn(hb)
        total += sum(int(getattr(v, "nbytes", 0)) for v in db.values())
        if total > max_bytes:
            logger.warning(
                "device data cache: staged bytes exceed the %.1f GB budget "
                "after %d batches — falling back to streaming",
                max_bytes / 1e9, len(staged) + 1)
            return None
        staged.append(db)
    if not staged:
        return None
    logger.info("device data cache: %d batches (%.1f MB) staged on the device",
                len(staged), total / 1e6)
    return staged


def epoch_shuffled(staged: List[Dict[str, Any]], seed: int
                   ) -> Iterator[Dict[str, Any]]:
    """Infinite iterator: fresh shuffled ORDER each epoch (batch
    composition is fixed — the documented device-cache trade-off)."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(staged))
    while True:
        rng.shuffle(order)
        for i in order:
            yield staged[i]
