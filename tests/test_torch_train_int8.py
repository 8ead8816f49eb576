"""Five train steps with int8 AdamW moments (``parallel.
int8_optimizer_state``) of the port against the JAX package's
``make_train_step``, on the seven architectures of
tests/test_torch_training.py at model dtype float32, teacher-forced: the
port's step applied to JAX's state before each step, held against JAX's
state after it (tests/test_torch_train_trajectory.py has the helpers).

Free-running, the two runs part after a step or two, and not by a fault:
a moment code whose value lies within the packages' rounding noise of a
half step (≤ 1e-3 of the codes) is stored one code apart, and an element
whose second moment is small beside its block's largest stores a code 0
or 1 there, which moves its next update by a large factor (opt-proxy's
loss 0.6 % apart after 5 steps at lr 3e-4). Held per step: the loss
≤ 1e-4 relative (routed models 1e-3). The parameters after the step
≤ 1e-2 over the whole tree (routed 5e-2): an element whose stored second
moment is a code 0 takes an update of about m / (√(1 − β2) |g|), which
turns the gradient's rounding gap (1e-7 in fp32, 3e-3 through the bf16
experts) into that much of a large step (2.0e-3 seen on whisper, 1.3e-2
on deepseek; 1e-5 to 3e-4 with fp32 moments). The moments' codes and
scales from one state are held in tests/test_torch_training.py.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads)

import pytest

from test_torch_train_trajectory import check
from test_torch_training import ARCHS, ROUTED


@pytest.mark.parametrize("arch", ARCHS)
def test_five_int8_steps_match_jax(arch):
    routed = arch in ROUTED
    check(arch, int8=True, forced=True, pin=1e-3 if routed else 1e-4,
          params_pin=5e-2 if routed else 1e-2)
