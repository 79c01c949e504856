"""Port parity for the six dense LM archs at their smoke configs:
qwen1.5-4b (MHA, qkv bias), minitron-8b (GQA, squared ReLU), granite-34b
(MQA, GELU), h2o-danube-3-4b (sliding window), internvl2-26b (patch
embeddings prepended, padded vocab) and musicgen-large (learned positions).

For each, on the JAX draws bridged into the port, in float32 (the shared
checks of ``tests/lm_parity.py``): the init tree, ``forward`` (logits, aux),
``loss_fn`` and every gradient leaf, and ``prefill`` plus four decode steps
with the caches they leave, within atol 1e-5 plus rtol 1e-4.
"""
import pytest

from lm_parity import check_forward_loss_and_grads, check_init_tree, \
    check_prefill_and_decode

DENSE = ("qwen1.5-4b", "minitron-8b", "granite-34b", "h2o-danube-3-4b",
         "internvl2-26b", "musicgen-large")


@pytest.mark.parametrize("arch_id", DENSE)
def test_init_tree_matches_jax(arch_id):
    check_init_tree(arch_id)


@pytest.mark.parametrize("arch_id", DENSE)
def test_forward_loss_and_grads_match_jax(arch_id):
    check_forward_loss_and_grads(arch_id)


@pytest.mark.parametrize("arch_id", DENSE)
def test_prefill_and_decode_match_jax(arch_id):
    """h2o-danube-3-4b's prompt of 20 tokens passes its smoke window of 16,
    so the decode steps write its ring buffer past the wrap."""
    check_prefill_and_decode(arch_id, prompt=20 if arch_id == "h2o-danube-3-4b" else 8)


def test_internvl2_prefix_embeds_match_jax():
    """Five patch embeddings before the text: the logits cover both, the
    loss slices the prefix off, and every gradient agrees."""
    check_forward_loss_and_grads("internvl2-26b", prefix=5)


def test_internvl2_prefill_after_prefix_embeds_matches_jax():
    check_prefill_and_decode("internvl2-26b", prefix=5)
