"""LM training parity of the port against the JAX package on reduced
f32 models: ``forward_train`` logits and aux, and ``loss_fn``'s loss,
lm_loss, moe_aux and every gradient leaf, from the same parameters and
batch (tolerances in ``_torch_train_support``).  Sequences are 16
long, a multiple of the reference's reduced scan chunk."""
import pytest

from _torch_train_support import (assert_forward_train,  # noqa: F401
                                   assert_loss_and_grads, torch_one_thread)

ARCHS = ["qwen3-0.6b", "llama-2-7b", "gemma-7b", "starcoder2-7b",
         "musicgen-medium"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train(arch):
    assert_forward_train(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads(arch):
    assert_loss_and_grads(arch)
