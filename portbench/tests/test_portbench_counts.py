"""The frozen formulas against numbers worked out by hand."""
import _tiny  # noqa: F401
import pytest

from pbench import counts, spec


def test_scan_bytes_at_1024():
    # xc 2*1024*8192 + dt 4*1024*8192 + B, C 2*2*1024*16 + a_log 4*8192*16
    # + D 4*8192 + y 2*1024*8192 + h_final 4*8192*16
    fl, nb = counts.scan_fwd(1, 1024, 8192, 16)
    assert nb == 68_255_744
    assert fl == 1024 * 8192 * (7 * 16 + 3)


def test_deepseek_kv_bytes_a_token():
    m = spec.load_json(spec.ROOT / "configs" / "deepseek-moe-16b.json")
    assert counts.kv_bytes_per_token(m["model"]) == 229_376


def test_causal_pairs_and_flash():
    assert counts.causal_pairs(4, 4) == 10
    assert counts.causal_pairs(2, 5, 3) == 4 + 5
    fl, nb = counts.flash_fwd(1, 1024, 1024, 16, 16, 128)
    assert fl == 4 * 128 * 16 * (1024 * 1025 // 2)
    assert nb == 2 * (2 * 1024 * 16 * 128 + 2 * 1024 * 16 * 128)


def test_decode_attn():
    fl, nb = counts.decode_attn(2, 16, 16, 128, 300)
    assert fl == 4 * 128 * 16 * 300
    assert nb == 2 * 2 * 300 * 16 * 128 + 2 * 2 * 2 * 16 * 128 + 8


def test_bound_takes_the_larger():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_token_params_and_flops():
    ds = spec.load_json(spec.ROOT / "configs" / "deepseek-moe-16b.json")
    fm = spec.load_json(spec.ROOT / "configs" / "falcon-mamba-7b.json")
    # deepseek: 28 x 4 x 2048^2 attention, 3 x 2048 x 10944 dense first
    # layer, 27 x (2048 x 64 router + 8 x 3 x 2048 x 1408), 2048 x 102400
    want = (28 * 4 * 2048 * 2048 + 3 * 2048 * 10944
            + 27 * (2048 * 64 + 8 * 3 * 2048 * 1408) + 2048 * 102400)
    assert counts.token_matmul_params(ds["model"], ds["family"]) == want
    # falcon: 64 x (4096 x 16384 + 8192 x 288 + 256 x 8192 + 8192 x 4096)
    # + 4096 x 65024
    want = 64 * (4096 * 16384 + 8192 * 288 + 256 * 8192 + 8192 * 4096) \
        + 4096 * 65024
    assert counts.token_matmul_params(fm["model"], fm["family"]) == want
    f1 = counts.token_flops(ds["model"], ds["family"], 1)
    f2 = counts.token_flops(ds["model"], ds["family"], 2)
    assert f2 - f1 == 4 * 16 * 128 * 28
    assert counts.prompt_flops(ds["model"], ds["family"], 3) == \
        sum(counts.token_flops(ds["model"], ds["family"], i)
            for i in (1, 2, 3))
