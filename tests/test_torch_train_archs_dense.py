"""One training step of the port against the reference's, on the CPU at the
reduced configs of the dense family (deepseek-7b, h2o-danube-1.8b with its sliding
window, command-r-plus-104b's parallel block and qk-norm, starcoder2-15b's
biases, layernorm and gelu, chameleon-34b): the loss and every leaf's gradient against
``jax.value_and_grad`` of the reference's ``loss_fn`` (2e-4 of each
leaf's max, tests/test_torch_training.py), the step's loss, grad norm and
lr against the reference's. ``cuda``-marked: the card against the CPU.
"""
import pytest

from test_torch_training import (_Reference, card_step_matches_the_cpu,
                                 one_step_matches_the_reference)

ARCHS = ("deepseek-7b", "h2o-danube-1.8b", "command-r-plus-104b", "starcoder2-15b",
         "chameleon-34b")


@pytest.fixture(scope="module")
def ref():
    return _Reference()


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_matches_the_reference(ref, arch):
    one_step_matches_the_reference(ref, arch)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_step_matches_the_cpu(arch):
    card_step_matches_the_cpu(arch)
