"""``metrics/moe_grouped_share.py`` on synthetic slices of kineto events
(the span readers' ``Ev`` and ``reading``): the share of
``repro.moe.experts`` spans in which a ``grouped_ffn`` kernel was
launched, each launch placed by its runtime call through the
correlation ids; 0 for a program that runs the per-expert loop, None
where the run was not traced or recorded no experts span."""
import pytest

import _tiny
from pbench import runner
from test_portbench_spans import Ev, events, reading

GROUPED = "void (anonymous namespace)::grouped_ffn_gemm<0>(CUtensorMap_st)"


def _layers(kernel_in):
    """Three experts spans over 0-90 ms (and a fourth open past the
    slice's end), each launching either the grouped kernel (its index in
    ``kernel_in``) or a library GEMM, then the harness's closing
    synchronize at 100-105 ms."""
    out = []
    for i, (s, e) in enumerate(((0, 20), (30, 50), (60, 80), (95, 120))):
        out.append(Ev("repro.moe.experts", s, e, corr=800 + i))
        name = GROUPED if i in kernel_in else "nvjet_tst_64x8_64x16"
        out += [Ev("cudaLaunchKernel", s + 2, s + 3, corr=10 + i),
                Ev(name, s + 4, s + 9, 10 + i, 0, True)]
    # a grouped launch outside every experts span counts for none
    out += [Ev("cudaLaunchKernel", 85, 86, corr=20),
            Ev(GROUPED, 86, 88, 20, 0, True),
            Ev("cudaDeviceSynchronize", 100, 105, corr=21)]
    return out


def _read(evs):
    return runner._reader(_tiny.PB, "moe_grouped_share")(reading(evs))


@pytest.mark.parametrize("kernel_in,want", [
    ((0, 1, 2, 3), 100.0), ((0, 2), 200.0 / 3), ((), 0.0)])
def test_share_of_experts_spans_with_a_grouped_launch(kernel_in, want):
    """Two of the three spans inside the slice launch it: 66.7%; all of
    them (the span past the slice's end left out): 100; none, as on a
    parent that runs the loop: 0."""
    assert _read(_layers(kernel_in)) == pytest.approx(want, rel=1e-12)


def test_a_kernel_without_its_runtime_call_is_not_placed():
    """A grouped kernel whose launch was not recorded cannot be placed in
    a span, and counts for none."""
    evs = [e for e in _layers((0, 1, 2))
           if not (e.name() == "cudaLaunchKernel" and e._c == 11)]
    assert _read(evs) == pytest.approx(200.0 / 3, rel=1e-12)


def test_nothing_to_read_untraced_or_without_experts_spans():
    untraced = reading(_layers((0,)))
    untraced.trace = None
    read = runner._reader(_tiny.PB, "moe_grouped_share")
    assert read(untraced) is None
    # the span readers' slice has no experts span but one, and a parent
    # without spans has none at all
    assert _read([e for e in events() if e.name() != "repro.moe.experts"]) \
        is None
    assert _read([e for e in _layers((0,))
                  if not e.name().startswith("repro.")]) is None
