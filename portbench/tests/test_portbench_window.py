"""The window's arithmetic on synthetic stamps: rates over the whole
window, tails over every sample, and a stall inside the window moves
them."""
import _tiny  # noqa: F401
import numpy as np

from pbench import serve, window


def recorder(stall=0.0):
    """Two engines stepping in turn for 10 s, 0.1 s a step; each step
    decodes one token for each of 4 residents; one request is enqueued
    at t=3 and gets its first token at t=3.25; a stall of ``stall``
    seconds delays every step from t=5 on (the window grows by it)."""
    rec = serve.Recorder(10.0, 0)
    rec.open_t, rec.close_t = 0.0, 10.0 + stall
    for k in range(100):
        t0 = k / 10 + (stall if k >= 50 else 0.0)
        t1 = t0 + 0.1
        for r in range(4):
            rec.tok_walls[k % 2 * 10 + r].append(t1)
        rec.steps.append({"engine": k % 2, "t0": t0, "t1": t1,
                          "admitted": None, "prompt": 0,
                          "ctx": [100] * 4})
    rec.enq[99] = 3.0
    rec.tok_walls[99] = [3.25]
    return rec


def test_rates_and_tails():
    rec = recorder()
    e = window.end_to_end(rec, t_start=-20.0)
    assert abs(e["output_tok_s"] - 40.0) < 1e-6      # 4 tokens / 0.1 s
    assert e["prompt_tok_s"] == 0.0
    assert abs(e["tbt_p95_ms"] - 200.0) < 1e-6       # every other step
    assert abs(e["ttft_p90_s"] - 0.25) < 1e-9
    assert e["setup_s"] == 20.0


def test_a_stall_moves_them():
    base = window.end_to_end(recorder(), 0.0)
    st = window.end_to_end(recorder(stall=2.0), 0.0)
    assert st["output_tok_s"] < base["output_tok_s"] * 0.9
    assert st["tbt_p95_ms"] == base["tbt_p95_ms"]    # one gap in 50
    gaps = window.token_gaps(recorder(stall=2.0))
    assert max(gaps) > 2.0 and len(gaps) == len(window.token_gaps(
        recorder()))
    assert np.mean(gaps) > np.mean(window.token_gaps(recorder()))


def test_tokens_outside_the_window_do_not_count():
    rec = recorder()
    rec.open_t = 5.0
    e = window.end_to_end(rec, 0.0)
    assert abs(e["output_tok_s"] - 40.0) < 1e-6
    assert all(t >= 5.0 for t in [s["t0"] for s in rec.window_steps()])
    assert e["ttft_p90_s"] is None


def test_reading_leaves_out_the_slice():
    rec = recorder()
    from pbench import spec
    cell = spec.load_cell("deepseek-moe-16b.long_prompt")
    r = window.Reading(rec, cell, None, excluded=(4.0, float("inf")))
    assert abs(r.wall_s - 4.0) < 1e-9
    assert all(s["t0"] < 4.0 for s in r.steps)
