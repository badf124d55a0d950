"""The one traffic generator: deterministic by seed, with the stated
length and arrival shapes, the same work for every seed."""
import collections
import statistics

import numpy as np
import pytest

from port_bench.harness import manifest, traffic
from port_bench.harness.traffic import Mix

SEED = 2**31 + 977


@pytest.fixture(params=["rag", "docs", "longdocs"])
def mix_file(request, root):
    return manifest.load_json(root / "port_bench" / "traffic"
                              / f"{request.param}.json")


def test_block_sizes():
    assert traffic.block_size([0.4, 0.3, 0.2, 0.1]) == 10
    assert traffic.block_size([0.8, 0.2]) == 5
    assert traffic.block_size([0.4, 0.35, 0.25]) == 20
    assert traffic.block_size([1.0]) == 1
    with pytest.raises(ValueError):
        traffic.block_size([0.5, 0.4])


def test_same_seed_same_requests(mix_file):
    a, b = Mix(mix_file, SEED, 1000), Mix(mix_file, SEED, 1000)
    assert [a.size(i) for i in range(200)] == [b.size(i) for i in range(200)]
    assert a.tokens(7) == b.tokens(7)
    assert all(0 <= t < 1000 for t in a.tokens(3))
    assert len(a.tokens(5)) == a.size(5)[0]
    c = Mix(mix_file, SEED + 1, 1000)
    assert [a.size(i) for i in range(200)] != [c.size(i) for i in range(200)]


def test_lengths_in_their_ranges_at_their_weights(mix_file):
    for key, stream in (("prompt", 0), ("output", 1)):
        comps = mix_file[key]
        n = traffic.block_size([c["weight"] for c in comps]) * 40
        for seed in (SEED, 5):
            m = Mix(mix_file, seed, 100)
            vals = [m.size(i)[stream] for i in range(n)]
            for c in comps:
                inside = sum(c["lo"] <= v <= c["hi"] for v in vals)
                assert inside == round(c["weight"] * n), (key, c)


def test_every_seed_gets_the_same_multiset_per_block(root):
    rag = manifest.load_json(root / "port_bench" / "traffic" / "rag.json")
    a, b = Mix(rag, 1, 100), Mix(rag, 2, 100)
    pa = sorted(a.size(i)[0] for i in range(20))
    pb = sorted(b.size(i)[0] for i in range(20))
    assert pa == pb == sorted([1024] * 8 + [2048] * 7 + [4096] * 5)
    assert [a.size(i)[0] for i in range(20)] != \
        [b.size(i)[0] for i in range(20)]
    # outputs: 4 short (8-16) and 1 long (48-64) in every block of 5
    for m in (a, b):
        for j in range(4):
            outs = [m.size(5 * j + k)[1] for k in range(5)]
            assert sum(o >= 48 for o in outs) == 1


def test_open_loop_arrivals_are_poisson_at_the_rate():
    rate, horizon = 4.0, 500.0
    t = traffic.arrivals(rate, horizon, SEED)
    assert t[0] == 0.0 and np.all(np.diff(t) >= 0) and t[-1] <= horizon
    assert abs(len(t) / horizon - rate) / rate < 0.02
    gaps = np.diff(t)
    assert abs(gaps.mean() * rate - 1) < 0.02
    assert abs(gaps.std() / gaps.mean() - 1) < 0.1      # exponential: CV 1
    np.testing.assert_array_equal(t, traffic.arrivals(rate, horizon, SEED))
    assert not np.array_equal(t, traffic.arrivals(rate, horizon, SEED + 1))


def test_the_mixes_are_closed_loops(root):
    loops = {n: manifest.load_json(root / "port_bench" / "traffic"
                                   / f"{n}.json")["loop"]
             for n in ("rag", "docs", "longdocs")}
    assert set(loops.values()) == {"closed"}
    with pytest.raises(ValueError):
        Mix({"loop": "half", "prompt": [], "output": []}, 1, 10)


def test_prompt_lengths_are_the_shapes_to_warm(root):
    rag = manifest.load_json(root / "port_bench" / "traffic" / "rag.json")
    assert Mix(rag, 1, 10).prompt_lengths() == [1024, 2048, 4096]
    counts = collections.Counter(Mix(rag, 1, 10).size(i)[0]
                                 for i in range(1000))
    assert counts == {1024: 400, 2048: 350, 4096: 250}
    assert statistics.mean(Mix(rag, 1, 10).size(i)[1]
                           for i in range(1000)) == pytest.approx(
        0.8 * 12 + 0.2 * 56, abs=0.5)
