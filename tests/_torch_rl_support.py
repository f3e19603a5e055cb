"""Helpers shared by the port's router tests: nested stats held to the
reference's, and learned networks held to the reference's."""
import jax
import numpy as np
import pytest

from repro_torch.training import checkpoint as pt_ckpt


def assert_same(got, want, path="stats", rel=1e-9, abs_=1e-12):
    """Nested stats equal: keys and ints exactly, floats to ``rel``
    relative or ``abs_`` absolute."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}", rel, abs_)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]", rel, abs_)
    elif isinstance(want, float) and not isinstance(got, bool):
        assert got == pytest.approx(want, rel=rel, abs=abs_,
                                    nan_ok=True), path
    else:
        assert got == want, path


def assert_params_close(pt, ref, tol=1e-5):
    """The port agent's learned network within ``tol`` of the tree's
    largest magnitude of the reference agent's -- except where the
    reference's Adam second moment says a gradient never left rounding
    level (sqrt(v) < 1e-6): Adam moves such a parameter by any value in
    [-lr, lr] a step in either framework (ROADMAP §3), so there the two
    may part by at most 2 lr a learn step."""
    got = pt_ckpt._flatten(pt.params.tree())
    want = pt_ckpt._flatten(jax.tree.map(np.asarray, ref.params))
    v = pt_ckpt._flatten(jax.tree.map(np.asarray, ref.opt["v"]))
    assert list(got) == list(want)
    scale = max(float(np.abs(x).max()) for x in want.values())
    for key in want:
        sure = np.sqrt(v[key]) >= 1e-6
        np.testing.assert_allclose(got[key][sure], want[key][sure],
                                   rtol=tol, atol=tol * scale,
                                   err_msg=key)
        assert np.all(np.abs(got[key] - want[key])[~sure]
                      <= 2 * ref.steps * pt.cfg.lr), key


@pytest.fixture
def one_torch_thread():
    """The router's networks are a few thousand parameters: one intra-op
    thread is as fast as many, and keeps parallel test workers from
    oversubscribing the cores.  The previous setting is restored."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
