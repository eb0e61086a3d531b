"""The serving mixes' requests are a function of the seed alone, and every
seed deals out the same lengths; the window credits the work in flight at
its close by the share of its span inside it."""

from __future__ import annotations

import pytest

from colonybench import harness
from colonybench.traffic.requests import lengths, wave

MIXES = ["chat", "longdoc"]
BIG = 2**31 + 12345  # the driver's seeds pass 32 signed bits


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = harness.mix_file(name)
    assert wave(mix, BIG, 3, 50304) == wave(mix, BIG, 3, 50304)
    assert wave(mix, BIG, 3, 50304) != wave(mix, BIG + 1, 3, 50304)
    assert wave(mix, BIG, 3, 50304) != wave(mix, BIG, 4, 50304)


@pytest.mark.parametrize("name", MIXES)
def test_every_wave_holds_the_same_lengths(name):
    mix = harness.mix_file(name)
    want = sorted(lengths(mix["prompt"], mix["clients"]))
    for seed, index in ((0, 0), (BIG, 1), (7, 9)):
        reqs = wave(mix, seed, index, 1000)
        assert len(reqs) == mix["clients"]
        assert sorted(len(r["prompt"]) for r in reqs) == want
        assert sorted(r["max_new_tokens"] for r in reqs) == sorted(
            lengths(mix["output"], mix["clients"]))
        assert all(0 <= t < 1000 for r in reqs for t in r["prompt"])


@pytest.mark.parametrize("name", MIXES)
def test_lengths_fit_the_cache(name):
    mix = harness.mix_file(name)
    for key in ("prompt", "output"):
        got = lengths(mix[key], mix["clients"])
        assert min(got) >= mix[key]["min"] and max(got) <= mix[key]["max"]
    assert max(lengths(mix["prompt"], mix["clients"])) + mix["output"]["max"] <= mix["max_len"]


def test_quantile_points_by_hand():
    # median 100, sigma 0 gives every point at the median; clipping holds
    ln = {"dist": "lognormal"}
    assert lengths(dict(ln, median=100, sigma=0.0, min=1, max=500), 3) == [100, 100, 100]
    assert lengths(dict(ln, median=100, sigma=5.0, min=50, max=200), 2) == [50, 200]
    with pytest.raises(ValueError):
        lengths({"dist": "zipf", "median": 100, "sigma": 1.0, "min": 1, "max": 9}, 2)


@pytest.mark.parametrize("ends,close,want", [
    ([10.0, 20.0, 30.0], 25.0, [1.0, 1.0, 0.5]),  # two whole units, half the third
    ([10.0, 20.0, 30.0], 20.0, [1.0, 1.0, 0.0]),
    ([10.0, 20.0, 30.0, 40.0], 25.0, [1.0, 1.0, 0.5, 0.0]),
    ([12.0, 24.0], 8.0, [8.0 / 12.0, 0.0]),  # nothing ended: the first unit's share
    ([10.0, 19.0, 30.0], 25.0, [1.0, 1.0, 6.0 / 11.0]),  # the span starts at the last end
])
def test_window_credits_by_hand(ends, close, want):
    from colonybench.window import credits

    assert credits(ends, 0.0, close) == pytest.approx(want)


def test_a_stall_moves_the_credited_work():
    """A unit that takes longer moves the count, though no unit crosses
    the close."""
    from colonybench.window import credits

    steady = sum(credits([17.0, 34.0, 51.0], 0.0, 39.0))
    stalled = sum(credits([17.0, 37.5, 54.5], 0.0, 39.0))
    assert steady == pytest.approx(2 + 5 / 17) and stalled == pytest.approx(2 + 1.5 / 17)
