"""The dry-run's argument bytes a device against the JAX reference's
``memory_analysis().argument_size_in_bytes``, byte for byte, for the
serving cells: prefill and decode of every registry config reduced to
one period on a (data=4, model=2) mesh (the decode cache with the
expanded heads where KV does not divide the model axis), a few on a
(pod=2, data=2, model=2) mesh, and a sequence-parallel decode (batch 1
under 4 data shards: the cache's sequence cut over them) of
falcon-mamba-7b and jamba-v0.1-52b.  One subprocess for the module runs
the reference (``tests/_torch_dryrun_oracle.py``).

One term is stated: a decode step never reads the vision projection nor
the cross layers' wk and wv (their K/V are in the cache), and
``jax.jit`` drops unused arguments from the executable
(``keep_unused=False``), so the reference's figure leaves their bytes
out; the port's step takes them, and the test adds them to the
reference's."""
import pytest

from repro_torch.common.config import ShapeConfig
from repro_torch.configs import REGISTRY, get_config
from repro_torch.launch import dryrun

import _torch_dryrun_support as sup

CELLS = ([{"set": "tiny", "arch": a, "kind": k, "mesh": "4x2"}
          for a in REGISTRY for k in ("prefill", "decode")]
         + [{"set": "tiny", "arch": a, "kind": k, "mesh": "2x2x2"}
            for a, k in (("qwen3-0.6b", "decode"),
                         ("deepseek-moe-16b", "prefill"),
                         ("minicpm3-4b", "decode"))]
         + [{"set": "tiny", "arch": a, "kind": "seqpar", "mesh": "4x2"}
            for a in ("falcon-mamba-7b", "jamba-v0.1-52b")])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return sup.run_oracle(tmp_path_factory, "dryrun_args_serve", CELLS,
                          "args")


def unread_in_decode(cfg, args, axes) -> int:
    """Bytes of the parameters a decode step never reads."""
    flat = dryrun._flat(args.params)
    specs = dryrun._flat_specs(args.params, args.param_specs)
    return sum(
        dryrun.sharding.local_nbytes(x.shape, x.dtype, specs[k], axes)
        for k, x in flat.items()
        if k[-1] == "vision_proj" or (
            k[-1] in ("wk", "wv") and k[0] == "layers"
            and cfg.layer_kind(int(k[1][1:-1])) == "cross"))


@pytest.mark.parametrize("cell", CELLS, ids=sup.key)
def test_argument_bytes_equal_the_reference(ref, cell):
    cfg, shape = sup.build(get_config, ShapeConfig, cell)
    axes = sup.MESHES[cell["mesh"]]
    args = dryrun.arguments(cfg, shape, axes)
    assert args.seq_parallel == (cell["kind"] == "seqpar")
    unread = unread_in_decode(cfg, args, axes) if shape.kind == "decode" \
        else 0
    assert unread == (12288 if cfg.vision_tokens and shape.kind == "decode"
                      else 0)
    assert args.local_bytes(axes) == ref[sup.key(cell)]["argument"] + unread
