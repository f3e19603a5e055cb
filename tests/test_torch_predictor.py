"""The port's length predictor against the JAX package's, on the CPU.

The encoder's logits on carried weights (to 1e-5), one Adam train step,
a one-epoch ``fit``, ``predict`` / ``TaskClassifier`` /
``TracePredictor`` on carried weights, the d-hat plumbing, and the
gateway's ``MicroBatchPredictor`` (buckets, forwards, LRU hits, misses
and eviction).  Small encoders, except one logits check at the
reference's default width."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictor as ref_pred
from repro.core import workload as ref_wl
from repro.core.profiles import V100_LLAMA2_7B as REF_V100
from repro.serving import gateway as ref_gw
from repro_torch.core import predictor as pt_pred
from repro_torch.core import workload as pt_wl
from repro_torch.core.profiles import V100_LLAMA2_7B as PT_V100
from repro_torch.serving import gateway as pt_gw
from repro_torch.training import checkpoint as pt_ckpt

TOL = 1e-5
SMALL = dict(seq_len=32, d_model=16, n_heads=2, n_layers=1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(cfg_kw=SMALL, seed=0):
    ref = ref_pred.BucketPredictor(ref_pred.PredictorConfig(**cfg_kw),
                                   REF_V100, seed=seed)
    pt = pt_pred.BucketPredictor(pt_pred.PredictorConfig(**cfg_kw),
                                 PT_V100, seed=seed, device="cpu")
    pt.from_reference(_np(ref.params))
    return ref, pt


def _ref_logits(ref, samples):
    tok = np.stack([ref_pred.encode_sample(ref.cfg, s) for s in samples])
    return np.asarray(ref_pred.apply_jit(ref.params, ref.cfg,
                                         jnp.asarray(tok)))


def _close(got, want, what=""):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def test_config_and_encoding_match_reference():
    assert pt_pred.PredictorConfig() == pt_pred.PredictorConfig(
        **ref_pred.PredictorConfig().__dict__)
    for use_hint in (True, False):
        rc = ref_pred.PredictorConfig(use_hint=use_hint, seq_len=24)
        pc = pt_pred.PredictorConfig(use_hint=use_hint, seq_len=24)
        for s in ref_wl.generate(20, seed=3):
            np.testing.assert_array_equal(pt_pred.encode_sample(pc, s),
                                          ref_pred.encode_sample(rc, s))


@pytest.mark.parametrize("cfg_kw", [SMALL, {}], ids=["small", "default"])
def test_logits_match_reference(cfg_kw):
    ref, pt = _pair(cfg_kw)
    samples = ref_wl.generate(96, seed=5)
    want = _ref_logits(ref, samples)
    got = pt.logits(samples, chunk=64)
    assert got.dtype == np.float32 and got.shape == want.shape
    _close(got, want)
    np.testing.assert_array_equal(pt.predict(samples),
                                  ref.predict(samples))


def test_logits_of_a_row_do_not_depend_on_the_batch():
    """The serving path pads to 16 rows and the batch path to 512: on
    the CPU the same prompt gives the same logits bit for bit (on the
    card within 1e-5, test_torch_cuda.py)."""
    _, pt = _pair({})
    samples = ref_wl.generate(40, seed=8)
    np.testing.assert_array_equal(pt.logits(samples, chunk=16),
                                  pt.logits(samples, chunk=512))


def test_parameter_tree_round_trips():
    ref, pt = _pair()
    tree = pt.params.reference_tree()
    want = _np(ref.params)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_train_step_matches_reference():
    ref, pt = _pair()
    samples = ref_wl.generate(32, seed=6)
    tok = np.stack([ref_pred.encode_sample(ref.cfg, s) for s in samples])
    lab = np.asarray([ref.label(s) for s in samples], np.int32)
    params, opt, loss = ref_pred._train_step(
        ref.params, ref.opt, ref.cfg, jnp.asarray(tok), jnp.asarray(lab))
    loss_pt = pt_pred._train_step(pt.params, pt.opt, pt.cfg,
                                  torch.from_numpy(tok).long(),
                                  torch.from_numpy(lab).long())
    _close(float(loss_pt), float(loss), "loss")
    got = pt.params.reference_tree()
    for (path, want), have in zip(
            jax.tree_util.tree_flatten_with_path(_np(params))[0],
            jax.tree.leaves(got)):
        _close(have, want, jax.tree_util.keystr(path))
    for key in ("m", "v"):
        want = pt_ckpt._flatten(_np(opt[key]))
        have = {k.replace("layers.", "layers/").replace(".", "/"):
                v.numpy() for k, v in pt.opt[key].items()}
        scale = max(float(np.abs(v).max()) for v in want.values())
        for k in want:
            np.testing.assert_allclose(have[k], want[k], rtol=TOL,
                                       atol=TOL * scale, err_msg=k)
    assert pt.opt["step"].dtype == torch.int32 and int(pt.opt["step"]) == 1


def test_fit_one_epoch_matches_reference():
    cfg_kw = dict(SMALL, batch=16)
    ref, pt = _pair(cfg_kw)
    samples = ref_wl.generate(80, seed=7)
    losses_ref = ref.fit(samples, epochs=1, seed=3)
    losses_pt = pt.fit(samples, epochs=1, seed=3)
    np.testing.assert_allclose(losses_pt, losses_ref, rtol=1e-4)
    _close(pt.logits(samples[:32]), _ref_logits(ref, samples[:32]))


def test_predict_and_bucket_helpers_match_reference():
    ref, pt = _pair()
    samples = ref_wl.generate(60, seed=9)
    np.testing.assert_array_equal(pt.predict(samples, chunk=16),
                                  ref.predict(samples, chunk=16))
    assert pt.accuracy(samples) == ref.accuracy(samples)
    np.testing.assert_array_equal(pt.decode_estimate(samples),
                                  ref.decode_estimate(samples))
    for b in range(10):
        assert pt.bucket_upper_tokens(b) == ref.bucket_upper_tokens(b)
    for d in (0, 1, 37, 250, 999, 5000, 40000):
        assert pt.bucket_of(d) == ref.bucket_of(d)
    for eq in (False, True):
        r = ref_pred.BucketPredictor(ref.cfg, REF_V100, equal_buckets=eq)
        p = pt_pred.BucketPredictor(pt.cfg, PT_V100, equal_buckets=eq,
                                    device="cpu")
        assert [p.label(s) for s in samples] == [r.label(s)
                                                 for s in samples]
        assert p.bucket_of(1234) == r.bucket_of(1234)


def test_task_classifier_matches_reference():
    ref = ref_pred.TaskClassifier(REF_V100, seed=1)
    pt = pt_pred.TaskClassifier(PT_V100, seed=1, device="cpu")
    pt.from_reference(_np(ref.params))
    samples = ref_wl.generate(50, seed=10)
    assert pt.n_out == ref.n_out and not pt.cfg.use_hint
    assert [pt.label(s) for s in samples] == [ref.label(s) for s in samples]
    _close(pt.logits(samples), _ref_logits(ref, samples))
    np.testing.assert_array_equal(pt.predict(samples), ref.predict(samples))


def test_trace_predictor_matches_reference():
    samples = ref_wl.generate_trace(120, seed=2)
    ref = ref_pred.TracePredictor(REF_V100, n_apps=5, seed=0)
    pt = pt_pred.TracePredictor(PT_V100, n_apps=5, seed=0, device="cpu")
    pt.from_reference(*(np.asarray(a) for a in
                        (ref.w1, ref.b1, ref.w2, ref.b2)))
    np.testing.assert_array_equal(pt.predict(samples), ref.predict(samples))
    ref.fit(samples, epochs=30)
    pt.fit(samples, epochs=30)
    for a, b in zip((pt.w1, pt.b1, pt.w2, pt.b2),
                    (ref.w1, ref.b1, ref.w2, ref.b2)):
        _close(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(pt.predict(samples), ref.predict(samples))
    assert pt.accuracy(samples) == ref.accuracy(samples)


def test_d_hat_plumbing_matches_reference():
    ref, pt = _pair()
    samples = ref_wl.generate(30, seed=11)
    reqs_r = ref_wl.to_requests(samples, rate=5.0, seed=12)
    reqs_p = pt_wl.to_requests(samples, rate=5.0, seed=12)
    ref_pred.annotate_requests(ref, reqs_r, samples)
    pt_pred.annotate_requests(pt, reqs_p, samples)
    assert [(r.predicted_bucket, r.predicted_decode) for r in reqs_p] == \
        [(r.predicted_bucket, r.predicted_decode) for r in reqs_r]
    assert [pt_pred.predicted_decode(r) for r in reqs_p] == \
        [ref_pred.predicted_decode(r) for r in reqs_r]
    fresh = pt_wl.to_requests(samples[:3], rate=5.0, seed=12)
    assert [pt_pred.predicted_decode(r) for r in fresh] == \
        [r.decode_tokens for r in fresh]
    for d, p in ((10, 5), (10 ** 6, 100), (3, 4000)):
        assert pt_pred.serviceable_decode(PT_V100, d, p) == \
            ref_pred.serviceable_decode(REF_V100, d, p)

    def scn_fn(mod, prof):
        return lambda ep: mod.make_tenant_scenario(
            seed=ep, n_requests=12, rate=4.0, profiles=(prof,) * 2)
    scn_r = ref_pred.annotating_stream(scn_fn(ref_wl, REF_V100), ref)(1)
    scn_p = pt_pred.annotating_stream(scn_fn(pt_wl, PT_V100), pt)(1)
    assert [r.predicted_decode for r in scn_p.requests] == \
        [r.predicted_decode for r in scn_r.requests]


def test_quick_bucket_predictor_trains_on_the_requested_device():
    cfg = pt_pred.PredictorConfig(**SMALL)
    pred = pt_pred.quick_bucket_predictor(PT_V100, n_train=128, epochs=1,
                                          cfg=cfg, device="cpu")
    assert int(pred.opt["step"]) == 1
    assert 0.0 <= pred.accuracy(pt_wl.generate(64, seed=99)) <= 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt_pred.quick_bucket_predictor(PT_V100, n_train=128, cfg=cfg)


def _services(batch_pad=16, cache_size=4096):
    ref, pt = _pair()
    return (ref_gw.MicroBatchPredictor(ref, batch_pad=batch_pad,
                                       cache_size=cache_size),
            pt_gw.MicroBatchPredictor(pt, batch_pad=batch_pad,
                                      cache_size=cache_size))


def test_microbatch_predictor_matches_reference_and_caches():
    svc_r, svc_p = _services()
    samples = ref_wl.generate(40, seed=5)
    for seed in (6, 7):          # the second pass hits the LRU cache
        reqs_r = ref_wl.to_requests(samples, rate=10.0, seed=seed)
        reqs_p = pt_wl.to_requests(samples, rate=10.0, seed=seed)
        svc_r.prefetch(list(zip(reqs_r, samples)))
        svc_p.prefetch(list(zip(reqs_p, samples)))
        assert [(r.predicted_bucket, r.predicted_decode) for r in reqs_p] \
            == [(r.predicted_bucket, r.predicted_decode) for r in reqs_r]
        assert [svc_p.estimate(r) for r in reqs_p] == \
            [svc_r.estimate(r) for r in reqs_r]
        assert (svc_p.hits, svc_p.misses, svc_p.forwards) == \
            (svc_r.hits, svc_r.misses, svc_r.forwards)
    assert (svc_p.hits, svc_p.misses, svc_p.forwards) == (40, 40, 3)
    # the micro-batched buckets are the batch path's
    np.testing.assert_array_equal(
        [r.predicted_bucket for r in reqs_p],
        svc_p.predictor.predict(samples))
    blank = pt_wl.to_requests(samples[:1], rate=1.0)[0]
    assert svc_p.estimate(blank) == svc_r.default_d == svc_p.default_d
    assert svc_p.bucket_of(700) == svc_r.bucket_of(700)
    svc_p.prefetch([(blank, None)])       # no content: nothing to do
    assert svc_p.misses == 40


def test_microbatch_lru_evicts_oldest_as_reference():
    svc_r, svc_p = _services(batch_pad=8, cache_size=10)
    samples = ref_wl.generate(25, seed=9)
    for svc, mod in ((svc_r, ref_wl), (svc_p, pt_wl)):
        svc.prefetch(list(zip(mod.to_requests(samples, rate=10.0,
                                              seed=10), samples)))
        # the oldest 15 were evicted: re-asking for the first misses
        svc.prefetch(list(zip(mod.to_requests(samples[:2], rate=10.0,
                                              seed=11), samples[:2])))
        svc.prefetch(list(zip(mod.to_requests(samples[-2:], rate=10.0,
                                              seed=12), samples[-2:])))
    assert list(svc_p._cache) == list(svc_r._cache)
    assert len(svc_p._cache) == 10
    assert (svc_p.hits, svc_p.misses, svc_p.forwards) == \
        (svc_r.hits, svc_r.misses, svc_r.forwards) == (2, 27, 5)
