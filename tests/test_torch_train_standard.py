"""Parity of avr_torch's train step with the JAX package's on the array
recipe's model family (CPU, fp32), with the harness and the tolerances of
test_torch_train.py."""

import pytest
from test_torch_train import _check_params, _run_both, _tc


@pytest.mark.parametrize("mode", ["add", "concat"])
def test_two_fp32_standard_steps_with_channels_and_das_match_jax(mode):
    """The array recipe's model family: the standard variant with channel
    embeddings ("add", as the recipe has it, and "concat"), a batch of one
    8-microphone group, and both DAS losses on."""
    steps = _run_both(_tc(batch_size=8), standard=mode, das_reg_loss_weight=10.0,
                      das_ce_loss_weight=1.0)
    for _, _, _, jb, _, tb in steps:
        assert float(jb.das_reg) > 0 and float(jb.das_ce) > 0
    _check_params(steps)
