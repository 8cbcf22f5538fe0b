"""The traffic generator: the same seed gives the same traffic, another
seed other words and order over the same sizes and gaps."""

import numpy as np

from portbench import traffic
from portbench.harness import load_json


def _texts(mix, seed, n):
    targets = traffic.shuffled(traffic.target_phonemes(mix, n),
                               traffic.rng_for(seed, "order"))
    return traffic.TextMaker().texts(targets, traffic.rng_for(seed, "words"))


def test_same_seed_same_traffic_other_seed_other():
    mix = load_json("traffic", "bulk-narration")
    big = 2 ** 40 + 17  # seeds past 32 bits
    a, b = _texts(mix, big, 64), _texts(mix, big, 64)
    c = _texts(mix, big + 1, 64)
    assert a == b
    assert a != c
    t1 = traffic.arrivals(100.0, 5.0, traffic.rng_for(big, "arrivals"))
    t2 = traffic.arrivals(100.0, 5.0, traffic.rng_for(big, "arrivals"))
    t3 = traffic.arrivals(100.0, 5.0, traffic.rng_for(big + 1, "arrivals"))
    assert np.array_equal(t1, t2) and not np.array_equal(t1, t3)


def test_every_seed_asks_for_the_same_work():
    mix = load_json("traffic", "interactive-stream")
    sizes = [np.sort(traffic.shuffled(traffic.target_phonemes(mix, 500),
                                      traffic.rng_for(s, "order")))
             for s in (1, 2)]
    assert np.array_equal(*sizes)
    gaps = [np.sort(np.diff(traffic.arrivals(50.0, 10.0,
                                             traffic.rng_for(s, "x"))))
            for s in (1, 2)]
    assert abs(gaps[0].sum() - gaps[1].sum()) < 0.2
    t = traffic.arrivals(50.0, 10.0, traffic.rng_for(3, "x"))
    assert len(t) == 500 and t[0] == 0.0 and t[-1] < 10.0


def test_lengths_follow_the_mix():
    bulk = load_json("traffic", "bulk-narration")
    p = traffic.target_phonemes(bulk, 4096)
    assert p.min() >= 15 and p.max() <= 180
    assert abs(p.mean() / bulk["phonemes_per_s"] - 6.6) < 0.1
    tm = traffic.TextMaker()
    rng = np.random.default_rng(0)
    for target in (15, 86, 180):
        n = len(tm.tp.text_to_phonemes(tm.sentence(target, rng)))
        assert abs(n - target) <= 6
