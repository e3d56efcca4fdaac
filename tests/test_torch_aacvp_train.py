"""One AACVP-MVSNet train step of the port against mvs_tpu's on the CPU:
tests/test_torch_cvp_train.py's checks and bounds (loss and metrics, float64
and f32 gradients of every parameter, the attention's among them, and the
BatchNorm statistics) on AACVP's model: the attention feature tail and the
group-correlation volume, whose hypothesis gradient reaches the coarse
level through the sampling coordinates.
"""

import pytest

from test_torch_cvp_train import (make_step,  # noqa: F401 (collected here)
                                  test_train_step_batch_stats,
                                  test_train_step_float64_gradients_agree,
                                  test_train_step_gradients,
                                  test_train_step_loss_and_metrics)


@pytest.fixture(scope="module")
def step():
    return make_step("aacvp_mvsnet")
