"""The traffic copies: deterministic by seed, the same multiset of sizes
in every block whatever the seed, and the moments of the program's
generators they copy."""
import _tiny  # noqa: F401
import numpy as np
import pytest

from pbench import spec, traffic


def mix(name):
    return traffic.load_mix(spec.ROOT / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", ["table1", "table1_bursty", "prod_trace",
                                  "doc_qa"])
def test_deterministic_and_reordered(name):
    m = mix(name)
    a = traffic.stream(m, 200, 2.0, 5, 2147483999, vocab=1000)
    b = traffic.stream(m, 200, 2.0, 5, 2147483999, vocab=1000)
    c = traffic.stream(m, 200, 2.0, 5, 7, vocab=1000)
    assert [(x.arrival, x.prompt_tokens, x.decode_tokens) for x in a] == \
        [(x.arrival, x.prompt_tokens, x.decode_tokens) for x in b]
    assert all((x.tokens == y.tokens).all() for x, y in zip(a, b))
    blk = m["block"]
    sizes = lambda s: sorted((x.prompt_tokens, x.decode_tokens)
                             for x in s[:blk])
    assert sizes(a) == sizes(c)                  # same multiset ...
    assert [x.prompt_tokens for x in a[:blk]] != \
        [x.prompt_tokens for x in c[:blk]]       # ... in another order
    assert all(x.arrival == 0.0 for x in a[:5])
    assert all(np.diff([x.arrival for x in a]) >= 0)
    # both runs' gaps come from the mix's one cycle of gaps, rotated
    cyc = traffic.unit_gaps(m["arrivals"], m["gap_pool"],
                            m["pool_seed"] + 1,
                            m.get("sampling") == "stratified") / 2.0
    for s in (a, c):
        g = np.diff([0.0] + [x.arrival for x in s[5:]])
        assert np.abs(g[:, None] - cyc[None]).min(1).max() < 1e-9


@pytest.mark.parametrize("name,gen", [("table1", "generate"),
                                      ("prod_trace", "generate_trace")])
def test_moments_match_the_program(name, gen):
    from repro_torch.core import workload as wl
    ours = traffic.size_block(mix(name), 20000, seed=11)
    theirs = getattr(wl, gen)(20000, seed=11)
    for k, attr in ((1, "prompt_tokens"), (2, "decode_tokens")):
        a = np.array([s[k] for s in ours], float)
        b = np.array([getattr(s, attr) for s in theirs], float)
        assert abs(a.mean() / b.mean() - 1) < 0.03
        assert abs(np.median(a) / np.median(b) - 1) < 0.05
        assert abs(a.std() / b.std() - 1) < 0.08


def test_stratified_block_keeps_the_shape():
    m = mix("table1")
    assert m["sampling"] == "stratified"
    blk = traffic.size_block(m)
    big = traffic.size_block(dict(m, sampling="random"), 20000, seed=11)
    for k in (1, 2):
        a = np.array([s[k] for s in blk], float)
        b = np.array([s[k] for s in big], float)
        assert abs(np.median(a) / np.median(b) - 1) < 0.15
        assert abs(a.mean() / b.mean() - 1) < 0.1
    g = traffic.unit_gaps({"pattern": "poisson"}, 24, 1, stratified=True)
    assert abs(g.mean() - 1) < 0.05


def test_bursty_rate_and_bursts():
    g = traffic.unit_gaps({"pattern": "bursty", "burst_factor": 6.0,
                           "persistence": 0.96}, 40000, 3)
    assert abs(1.0 / g.mean() - 1.0) < 0.1
    p = traffic.unit_gaps({"pattern": "poisson"}, 40000, 3)
    assert g.std() / g.mean() > 1.2 * p.std() / p.mean()
