"""One training step of the port against the reference's, on the CPU at the
reduced configs of the other families (MoE: mixtral-8x22b, granite-moe-3b-a800m with
their router and capacity dispatch; the zamba2-2.7b hybrid; the whisper-tiny
encoder-decoder with frames; the mamba2-1.3b SSM): the loss and every leaf's gradient against
``jax.value_and_grad`` of the reference's ``loss_fn`` (2e-4 of each
leaf's max, tests/test_torch_training.py), the step's loss, grad norm and
lr against the reference's. ``cuda``-marked: the card against the CPU.
"""
import pytest

from test_torch_training import (_Reference, card_step_matches_the_cpu,
                                 one_step_matches_the_reference)

ARCHS = ("mixtral-8x22b", "granite-moe-3b-a800m", "zamba2-2.7b", "whisper-tiny",
         "mamba2-1.3b")


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
