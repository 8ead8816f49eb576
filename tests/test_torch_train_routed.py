"""``loss_fn`` and its gradients of the two routed-MoE models (olmoe's
load-balance loss, deepseek's MTP head) against the JAX package's, at the
routed pins of tests/test_torch_training.py (its own file: the JAX loss
run op by op takes most of a minute on deepseek)."""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)

import pytest

from test_torch_training import ROUTED, check_loss_and_grads


@pytest.mark.parametrize("arch", ROUTED)
def test_routed_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)
