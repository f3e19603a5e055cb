"""The port's LLMInstance over the MLA, MoE and hybrid families against
the JAX reference's, in lockstep (``test_torch_engine.py``'s drive):
reduced minicpm3-4b (MLA latents), deepseek-moe-16b (a dense first
layer, routed and shared experts) and jamba-v0.1-52b (mamba, attention
and MoE layers).

Slot inserts write each family's cache entries (the latents, the first
layer's K/V, the conv/ssm states); the gang decode runs empty slots and
its MoE through ``gather``; requests are preempted and one decodes past
the cache.  Virtual-clock stamps and trace events are equal exactly,
logits and every cache entry within 1e-4 after each step."""
import pytest

from _torch_model_support import torch_one_thread  # noqa: F401
from test_torch_engine import _lockstep


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-moe-16b",
                                  "jamba-v0.1-52b"])
def test_family_engine_matches_reference_in_lockstep(arch):
    _lockstep(False, arch)
