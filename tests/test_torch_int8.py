"""int8 rollouts of the port against zeggs_tpu's, 24 frames at small width
(H=128, 8 joints), the size of tests/test_pallas_kernels.py.

* The int8 packing and `rollout_b1_plain` (the int8 decoder kernel's plain
  version) against the Pallas kernel's int8 branch in interpret mode. Both
  quantize the same activations the same way and sum int8 products
  exactly, so they differ only where float32 sums elsewhere (gates,
  conditioning) move an activation across a rounding boundary: pose MAE
  < 1e-4, and the packed int8 weights equal, scales to 1e-7.
* `rollout(quantize_int8=True)` against `decoder.rollout(quantize_int8=True)`
  at B=2: the same bound.
* Both int8 paths against the fp32 rollout within the JAX tests' bound,
  max error / max(1, max|ref|) < 3e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zeggs_tpu.models import decoder as jdec
from zeggs_tpu.ops.pallas import decoder_kernel as DK
from zeggs_tpu_torch.io import weights
from zeggs_tpu_torch.models import decoder as tdec
from zeggs_tpu_torch.models.decoder import Decoder
from zeggs_tpu_torch.ops.kernels import decoder_rollout as DR

NJ = 8
POSE_IN, POSE_OUT = 6 + NJ * 15 + 3, 6 + NJ * 15
H, S, C, T = 128, 16, 8, 24
DT = 1.0 / 60.0
NAMES = ["root_pos", "root_rot", "root_vel", "root_vrt", "lpos", "ltxy", "lvel", "lvrt"]
POSE_MAE = 1e-4
QUANT_BOUND = 3e-2


def _case(B, seed=0):
    params = jdec.init(jax.random.PRNGKey(3), POSE_IN, POSE_OUT, S, C, H, 2, "normal")
    dec = Decoder(POSE_IN, POSE_OUT, S, C, H)
    dec.load_state_dict(weights.from_jax(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(seed)
    stats = (
        rng.normal(size=POSE_IN).astype(np.float32) * 0.05,
        rng.uniform(0.5, 2.0, POSE_IN).astype(np.float32),
        rng.normal(size=POSE_OUT).astype(np.float32) * 0.05,
        rng.uniform(0.5, 2.0, POSE_OUT).astype(np.float32),
    )
    q = rng.normal(size=(B, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    state0 = (
        rng.normal(size=(B, 3)).astype(np.float32),
        q,
        rng.normal(size=(B, 3)).astype(np.float32) * 0.1,
        rng.normal(size=(B, 3)).astype(np.float32) * 0.1,
        rng.normal(size=(B, NJ, 3)).astype(np.float32),
        rng.normal(size=(B, NJ, 2, 3)).astype(np.float32),
        rng.normal(size=(B, NJ, 3)).astype(np.float32) * 0.1,
        rng.normal(size=(B, NJ, 3)).astype(np.float32) * 0.1,
    )
    cond = (
        rng.normal(size=(B, T, 3)).astype(np.float32),
        rng.normal(size=(B, T, S)).astype(np.float32),
        rng.normal(size=(B, T, C)).astype(np.float32),
    )
    return params, dec.eval(), stats, state0, cond


@pytest.fixture(scope="module")
def b1():
    return _case(1)


def _j(arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _t(arrs):
    return tuple(torch.as_tensor(a) for a in arrs)


def _assert_close(ours, ref, pose_mae=POSE_MAE):
    for name, a, b in zip(NAMES, ref, ours):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        assert np.isfinite(b).all(), name
        mae = float(np.abs(a - b).mean())
        assert mae < pose_mae, f"{name}: MAE {mae}"


def _assert_within_quantization(ours, fp32):
    for name, a, b in zip(NAMES, fp32, ours):
        a, b = np.asarray(a), np.asarray(b)
        err = np.abs(b - a).max() / max(1.0, float(np.abs(a).max()))
        assert err < QUANT_BOUND, (name, err)


def test_int8_packing_matches_jax(b1):
    params, dec, stats, _, _ = b1
    ref = DK.pack_decoder_weights(params["cell"], POSE_IN, jnp.int8)
    packed = DR.pack_decoder(dec.cell, *_t(stats), weights_dtype=torch.int8)
    G = 3 * H
    assert packed.wx.dtype == packed.wh.dtype == torch.int8
    assert packed.kx % 16 == 0
    # the port's rows are the JAX package's columns
    np.testing.assert_array_equal(packed.wx[:, :POSE_IN].numpy(),
                                  np.asarray(ref["wx"])[:POSE_IN].T)
    np.testing.assert_array_equal(packed.wh.numpy(), np.asarray(ref["wh"])[:, : 4 * G + POSE_OUT].T)
    np.testing.assert_allclose(packed.sx.numpy(), np.asarray(ref["sx"])[0], atol=1e-7, rtol=0)
    np.testing.assert_allclose(packed.sh.numpy(), np.asarray(ref["sh"])[0, : 4 * G + POSE_OUT],
                               atol=1e-7, rtol=0)
    assert packed.w_cond_l0.dtype == packed.w_cond_g0.dtype == torch.bfloat16


def test_all_zero_row_gets_scale_one():
    _, dec, stats, _, _ = _case(1)
    with torch.no_grad():
        dec.cell.out.weight[3] = 0.0
        packed = DR.pack_decoder(dec.cell, *_t(stats), weights_dtype=torch.int8)
    assert packed.sh[12 * H + 3].item() == 1.0
    assert torch.count_nonzero(packed.wh[12 * H + 3]) == 0


def test_rollout_b1_plain_int8_matches_pallas_kernel(b1):
    params, dec, stats, state0, cond = b1
    jfn = jdec.make_fused_b1_fn(params, *_j(stats), DT, weights_dtype=jnp.int8, interpret=True)
    ref = jfn(_j(state0), *_j(cond))
    launches = DR.launches
    with torch.no_grad():
        tfn = tdec.make_fused_b1_fn(dec, *_t(stats), DT, weights_dtype=torch.int8)
        ours = tfn(_t(state0), *_t(cond))
    assert DR.launches == launches, "CPU tensors must take the plain version, not count a launch"
    _assert_close(ours, ref)
    fp32 = jdec.rollout(params, *_j(state0), *_j(cond), *_j(stats), DT)
    _assert_within_quantization(ours, fp32)


def test_activation_quantization_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, -2.5, 0.0])
    q, s = DR.quantize_act(x)
    assert s.item() == 1.0
    assert q.tolist() == [127.0, 0.0, 2.0, -2.0, 0.0]
    q, s = DR.quantize_act(torch.zeros(4))
    assert s.item() == pytest.approx(1e-8 / 127.0) and q.abs().max().item() == 0.0


def test_batched_int8_rollout_matches_jax():
    params, dec, stats, state0, cond = _case(2, seed=1)
    ref = jdec.rollout(params, *_j(state0), *_j(cond), *_j(stats), DT, quantize_int8=True)
    with torch.no_grad():
        ours = tdec.rollout(dec, *_t(state0), *_t(cond), *_t(stats), DT, quantize_int8=True)
    _assert_close(ours, ref)
    fp32 = jdec.rollout(params, *_j(state0), *_j(cond), *_j(stats), DT)
    _assert_within_quantization(ours, fp32)


def test_batched_int8_rollout_selects_outputs():
    _, dec, stats, state0, cond = _case(2, seed=2)
    with torch.no_grad():
        whole = tdec.rollout(dec, *_t(state0), *_t(cond), *_t(stats), DT, quantize_int8=True)
        some = tdec.rollout(dec, *_t(state0), *_t(cond), *_t(stats), DT, quantize_int8=True,
                            output_indices=(0, 1, 4, 5))
    for i, s in zip((0, 1, 4, 5), some):
        torch.testing.assert_close(s, whole[i], rtol=0, atol=0)
