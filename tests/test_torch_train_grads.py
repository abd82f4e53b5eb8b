"""Gradients of the port's deterministic training loss against
`jax.grad` of zeggs_tpu's, for the ``gru`` style body, the ``film`` decoder
cell and label styles (the ``attn``/``normal`` case is in
tests/test_torch_train.py, with the tolerances: per leaf max|diff| <=
1e-4 * max(1, max|g_jax|)), and for bfloat16 products."""

import pytest

from tests.test_torch_train import _assert_trees_close, check_gradients

BF16_LOSS_RTOL, BF16_GRAD_TOL = 1e-4, 4e-2


@pytest.mark.parametrize("kind", ["gru_normal", "attn_film", "label"])
def test_gradients_match_jax_grad(kind):
    check_gradients(kind)


def test_bfloat16_gradients_match_jax_grad():
    """``compute_dtype="bfloat16"`` on both sides, over one decoder step
    (2-frame windows). The two packages round different sums, so their
    bfloat16 runs agree only as far as rounding allows. Readings on the
    CPU: port against JAX, both bfloat16, loss 2.6e-5 relative and
    gradients 1.5e-2 of max(1, max|g|) at the worst leaf; the port at
    float32 against JAX at bfloat16, gradients 8.2e-2. So a port that
    ignored ``compute_dtype`` or ran GRU1 at float32 fails the gradient
    bound, and one that rounded the integrated pose to bfloat16 (loss
    2.5e-4) fails the loss bound. Over 16 frames the rounding compounds
    through the recurrence until the packages differ by 0.6 of the scale,
    more than either differs from float32, so a longer window tests less."""
    loss16, grads16, jax16 = check_gradients("attn_normal", "bfloat16", frames=2,
                                              loss_rtol=BF16_LOSS_RTOL, grad_tol=BF16_GRAD_TOL)
    loss32, grads32, _ = check_gradients("attn_normal", "float32", frames=2)
    # the products ran in bfloat16, and the bound tells them from float32 ones
    assert loss16 != loss32
    with pytest.raises(AssertionError):
        _assert_trees_close(grads32, jax16, BF16_GRAD_TOL)
