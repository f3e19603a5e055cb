"""The span readers (``metrics/_spans.py`` and the seven metrics on it)
on a synthetic slice of kineto events, whose numbers are worked by hand:
the innermost span takes each idle part, self times leave the children
out, the idle parts and ``unspanned`` add up to the slice's idle time,
and a kernel's device time goes to the span open at its launch, found
through the correlation ids.  Each reader returns None where the run was
not traced, and where the program recorded no spans (a parent commit)."""
import importlib.util
import statistics
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _tiny
from pbench import runner

MS = 1_000_000          # the synthetic clock's unit, in ns
READERS = ["route_span_ms", "prefill_span_ms_per_ktok", "decode_span_ms",
           "program_syncs_per_step", "sync_wait_ms_per_step",
           "moe_idle_share", "gateway_self_share"]


def _spans_module():
    sp = importlib.util.spec_from_file_location(
        "_spans", _tiny.PB / "metrics" / "_spans.py")
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


class Ev:
    def __init__(self, name, start, end, corr=0, link=0, device=False):
        self._n, self._s, self._e = name, start * MS, end * MS
        self._c, self._l, self._d = corr, link, device

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return int(self._s)

    def duration_ns(self):
        return int(self._e - self._s)

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def events():
    """Spans (nested as the program nests them), host ops, runtime calls
    and device intervals over 210 ms; the last span is open at the stop
    (it ends past every other event) and is left out."""
    sp = [("repro.gateway.route", 0, 30), ("repro.route", 5, 25),
          ("repro.sync.route_q", 15, 20), ("repro.cluster.advance", 35, 200),
          ("repro.engine.step", 40, 190), ("repro.engine.prefill", 45, 120),
          ("repro.model.ffn", 50, 100), ("repro.moe.experts", 55, 80),
          ("repro.sync.first_token", 105, 115),
          ("repro.engine.decode", 125, 185),
          ("repro.sync.next_tokens", 170, 180),
          ("repro.cluster.advance", 215, 230)]
    out = [Ev(n, s, e, corr=900 + i) for i, (n, s, e) in enumerate(sp)]
    out += [
        # route_q's host read
        Ev("aten::copy_", 16, 19, corr=4), Ev("cudaMemcpyAsync", 16.5, 17,
                                              corr=103, link=4),
        Ev("Memcpy DtoH (Device -> Pageable)", 17, 18, 103, 4, True),
        # an expert's GEMM, launched at 57 inside repro.moe.experts
        Ev("aten::mm", 56, 60, corr=1), Ev("cudaLaunchKernel", 57, 59,
                                           corr=100, link=1),
        Ev("gemm", 60, 90, 100, 1, True),
        # the first token's read
        Ev("aten::_local_scalar_dense", 106, 114, corr=2),
        Ev("cudaMemcpyAsync", 107, 109, corr=101, link=2),
        Ev("Memcpy DtoH (Device -> Pinned)", 108, 110, 101, 2, True),
        # a kernel with no runtime call recorded: its op (at 126) stands
        # for the launch
        Ev("aten::add", 126, 128, corr=5),
        Ev("elementwise", 130, 160, 104, 5, True),
        # the next tokens' read
        Ev("aten::copy_", 171, 179, corr=3),
        Ev("cudaMemcpyAsync", 172, 174, corr=102, link=3),
        Ev("Memcpy DtoH (Device -> Pageable)", 173, 175, 102, 3, True),
        # a host read outside any sync span
        Ev("aten::item", 192, 194, corr=6),
        Ev("cudaMemcpyAsync", 192.5, 193, corr=105, link=6),
        Ev("Memcpy DtoH (Device -> Pinned)", 193, 194, 105, 6, True),
        # the harness's closing synchronize ends the slice
        Ev("cudaDeviceSynchronize", 205, 210, corr=106),
    ]
    return out


def reading(evs, steps=2, prompts=(500, 0)):
    result = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    return SimpleNamespace(
        trace={"steps": steps, "wall_s": 0.21, "busy_s": 0.066},
        rec=SimpleNamespace(profiler=SimpleNamespace(result=result)),
        slice_steps=[{"prompt": p} for p in prompts])


def close(a, b):
    return a == pytest.approx(b, rel=1e-9, abs=1e-12)


def test_idle_parts_go_to_the_innermost_span_and_add_up():
    d = _spans_module().walk(events())
    assert (d["lo"], d["hi"]) == (0, 210 * MS)
    # busy: 1 + 30 + 2 + 30 + 2 + 1 ms of 210
    assert close(d["idle_s"], 0.144)
    want = {"repro.gateway.route": 10, "repro.route": 15,
            "repro.sync.route_q": 4, "unspanned": 15,
            "repro.cluster.advance": 14, "repro.engine.step": 15,
            "repro.engine.prefill": 15, "repro.model.ffn": 15,
            "repro.moe.experts": 5, "repro.sync.first_token": 8,
            "repro.engine.decode": 20, "repro.sync.next_tokens": 8}
    assert set(d["idle_by"]) == set(want)
    for name, ms in want.items():
        assert close(d["idle_by"][name], ms / 1e3), name
    assert close(sum(d["idle_by"].values()), d["idle_s"])
    assert close(d["idle_under"]("repro.moe."), 0.005)
    assert close(d["idle_under"]("repro.engine."), 0.086)


def test_self_time_leaves_the_children_out():
    d = _spans_module().walk(events())
    spans = d["spans"]
    # the span open at the stop is not among them
    assert spans["repro.cluster.advance"]["n"] == 1
    want = {"repro.gateway.route": (30, 10), "repro.route": (20, 15),
            "repro.cluster.advance": (165, 15),
            "repro.engine.step": (150, 15),
            "repro.engine.prefill": (75, 15), "repro.model.ffn": (50, 25),
            "repro.moe.experts": (25, 25), "repro.engine.decode": (60, 50),
            "repro.sync.next_tokens": (10, 10)}
    for name, (wall, own) in want.items():
        assert close(spans[name]["wall_s"], wall / 1e3), name
        assert close(spans[name]["self_s"], own / 1e3), name


def test_device_time_goes_to_the_span_open_at_the_launch():
    d = _spans_module().walk(events())
    want = {"repro.moe.experts": 30, "repro.engine.decode": 30,
            "repro.sync.first_token": 2, "repro.sync.next_tokens": 2,
            "repro.sync.route_q": 1, "repro.cluster.advance": 1}
    assert set(d["device_by"]) == set(want)
    for name, ms in want.items():
        assert close(d["device_by"][name], ms / 1e3), name
    assert (d["d2h"], d["d2h_in_sync"]) == (4, 3)
    assert d["d2h_out"] == {"repro.cluster.advance": 1}
    assert d["sync_sites"] == {s: {"spans": 1, "d2h": 1} for s in
                               ("route_q", "first_token", "next_tokens")}


def test_the_readers_on_the_synthetic_slice(capsys):
    r = reading(events())
    got = {name: runner._reader(_tiny.PB, name)(r) for name in READERS}
    assert close(got["route_span_ms"], 20.0)
    assert close(got["decode_span_ms"], 60.0)
    assert close(got["prefill_span_ms_per_ktok"], 75.0 / 500 * 1e3)
    assert close(got["program_syncs_per_step"], 1.5)
    assert close(got["sync_wait_ms_per_step"], (5 + 10 + 10) / 2)
    assert close(got["moe_idle_share"], 100 * 5 / 210)
    assert close(got["gateway_self_share"], 100 * 10 / 210)
    # one walk, one summary line, whatever the number of readers
    err = capsys.readouterr().err
    assert err.count("spans: ") == 1


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_untraced_or_without_spans(name):
    read = runner._reader(_tiny.PB, name)
    untraced = reading(events())
    untraced.trace = None
    assert read(untraced) is None
    parent = reading([e for e in events()
                      if not e.name().startswith("repro.")])
    assert read(parent) is None


def test_the_walk_of_a_real_profile():
    """The program's spans as ``torch.profiler`` records them on the
    CPU: nested, with no device interval the slice is idle throughout,
    and the parts add up."""
    from repro_torch.serving import trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("repro.test.outer"):
            torch.ones(64, 64).sum()
            with trace.span("repro.test.inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            with trace.sync("test"):
                torch.ones(3).tolist()
        torch.ones(2).sum()
    d = _spans_module().walk(prof.profiler.kineto_results.events())
    spans = d["spans"]
    assert {k: v["n"] for k, v in spans.items()} == {
        "repro.test.outer": 1, "repro.test.inner": 1, "repro.sync.test": 1}
    outer = spans["repro.test.outer"]
    inner = [spans["repro.test.inner"], spans["repro.sync.test"]]
    assert close(outer["self_s"],
                 outer["wall_s"] - sum(s["wall_s"] for s in inner))
    assert close(d["idle_s"], (d["hi"] - d["lo"]) * 1e-9)
    assert close(sum(d["idle_by"].values()), d["idle_s"])
    assert d["idle_by"]["repro.test.inner"] == pytest.approx(
        spans["repro.test.inner"]["wall_s"], rel=1e-6)
    assert statistics.median(outer["walls"]) == outer["wall_s"]
