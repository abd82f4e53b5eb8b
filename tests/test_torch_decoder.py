"""The port's decoder rollouts against zeggs_tpu's, 24 frames at small
width (H=128, 8 joints).

Tolerance atol 3e-4 / rtol 1e-3, the fused-rollout budget of
tests/test_pallas_kernels.py: the same float32 math, summed in another
order, fed back through 23 autoregressive steps. The Pallas kernel runs in
interpret mode, as the JAX package's own tests run it on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zeggs_tpu.models import decoder as jdec
from zeggs_tpu_torch.io import weights
from zeggs_tpu_torch.models import decoder as tdec
from zeggs_tpu_torch.models.decoder import Decoder
from zeggs_tpu_torch.ops.kernels import build
from zeggs_tpu_torch.ops.kernels import decoder_rollout as DR

NJ = 8
POSE_IN, POSE_OUT = 6 + NJ * 15 + 3, 6 + NJ * 15
H, S, C, T = 128, 16, 8, 24
DT = 1.0 / 60.0
NAMES = ["root_pos", "root_rot", "root_vel", "root_vrt", "lpos", "ltxy", "lvel", "lvrt"]


@pytest.fixture(scope="module")
def case():
    params = jdec.init(jax.random.PRNGKey(3), POSE_IN, POSE_OUT, S, C, H, 2, "normal")
    dec = Decoder(POSE_IN, POSE_OUT, S, C, H)
    dec.load_state_dict(weights.from_jax(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(0)
    stats = (
        rng.normal(size=POSE_IN).astype(np.float32) * 0.05,
        rng.uniform(0.5, 2.0, POSE_IN).astype(np.float32),
        rng.normal(size=POSE_OUT).astype(np.float32) * 0.05,
        rng.uniform(0.5, 2.0, POSE_OUT).astype(np.float32),
    )
    q = rng.normal(size=(1, 4)).astype(np.float32)
    q /= np.linalg.norm(q)
    state0 = (
        rng.normal(size=(1, 3)).astype(np.float32),
        q,
        rng.normal(size=(1, 3)).astype(np.float32) * 0.1,
        rng.normal(size=(1, 3)).astype(np.float32) * 0.1,
        rng.normal(size=(1, NJ, 3)).astype(np.float32),
        rng.normal(size=(1, NJ, 2, 3)).astype(np.float32),
        rng.normal(size=(1, NJ, 3)).astype(np.float32) * 0.1,
        rng.normal(size=(1, NJ, 3)).astype(np.float32) * 0.1,
    )
    cond = (
        rng.normal(size=(1, T, 3)).astype(np.float32),
        rng.normal(size=(1, T, S)).astype(np.float32),
        rng.normal(size=(1, T, C)).astype(np.float32),
    )
    return params, dec.eval(), stats, state0, cond


def _j(arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _t(arrs):
    return tuple(torch.as_tensor(a) for a in arrs)


def _assert_trajectories(ours, ref, atol=3e-4, rtol=1e-3):
    for name, a, b in zip(NAMES, ref, ours):
        assert tuple(b.shape) == a.shape, name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol, rtol=rtol, err_msg=name)


def test_rollout_matches_jax(case):
    params, dec, stats, state0, cond = case
    ref = jdec.rollout(params, *_j(state0), *_j(cond), *_j(stats), DT)
    with torch.no_grad():
        ours = tdec.rollout(dec, *_t(state0), *_t(cond), *_t(stats), DT)
    _assert_trajectories(ours, ref)


def test_rollout_chunks_chain_to_one_rollout(case):
    """Two chunks from the carried state emit exactly the frames of one."""
    _, dec, stats, state0, cond = case
    s0, (gaze, speech, style), st = _t(state0), _t(cond), _t(stats)
    with torch.no_grad():
        carry = tdec.init_carry(dec, *s0, gaze[:, 0], style[:, 0], st[0], st[1])
        _, whole = tdec.rollout_chunk(dec, carry, gaze[:, 1:], speech[:, 1:], style[:, 1:], *st, DT)
        c1, first = tdec.rollout_chunk(dec, carry, gaze[:, 1:9], speech[:, 1:9], style[:, 1:9], *st, DT)
        _, rest = tdec.rollout_chunk(dec, c1, gaze[:, 9:], speech[:, 9:], style[:, 9:], *st, DT)
    for w, a, b in zip(whole, first, rest):
        torch.testing.assert_close(torch.cat([a, b], dim=1), w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rollout_b1_plain_matches_pallas_kernel(case, dtype):
    """The kernel's plain version against the Pallas whole-rollout kernel
    (interpret mode) at the same weight dtype: the same packed weights and
    the same rounding of every activation to that dtype."""
    params, dec, stats, state0, cond = case
    jfn = jdec.make_fused_b1_fn(params, *_j(stats), DT, weights_dtype=getattr(jnp, dtype),
                                interpret=True)
    ref = jfn(_j(state0), *_j(cond))
    launches = build.launches()
    with torch.no_grad():
        tfn = tdec.make_fused_b1_fn(dec, *_t(stats), DT, weights_dtype=getattr(torch, dtype))
        ours = tfn(_t(state0), *_t(cond))
    _assert_trajectories(ours, ref)
    assert build.launches() == launches, \
        "CPU tensors must take the plain version, not count a launch"


def test_rollout_b1_plain_bf16_tracks_fp32(case):
    """bf16 weights with activations rounded to bf16 stay within the pose
    MAE budget of docs/DESIGN.md section 5 (1e-3) of the fp32 rollout."""
    _, dec, stats, state0, cond = case
    with torch.no_grad():
        f32 = tdec.make_fused_b1_fn(dec, *_t(stats), DT, weights_dtype=torch.float32)(_t(state0), *_t(cond))
        b16 = tdec.make_fused_b1_fn(dec, *_t(stats), DT, weights_dtype=torch.bfloat16)(_t(state0), *_t(cond))
    for name, a, b in zip(NAMES, f32, b16):
        assert torch.isfinite(b).all(), name
    mae = torch.mean(torch.abs(b16[4] - f32[4])).item()
    assert 0.0 < mae < 1e-3, mae


def _packed_args(dec, stats, T1=5):
    packed = DR.pack_decoder(dec.cell, *_t(stats), weights_dtype=torch.float32)
    z = torch.zeros
    return packed, [z(T1, H), z(T1, 3 * H), z(T1, 3), z(POSE_OUT), z(2, H), z(7)]


@pytest.mark.parametrize("fault", ["shape", "dtype", "contiguity", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, fault):
    _, dec, stats, _, _ = case
    packed, args = _packed_args(dec, stats)
    if fault == "shape":
        args[1] = torch.zeros(5, 2 * H)
        err = ValueError
    elif fault == "dtype":
        args[2] = args[2].double()
        err = TypeError
    elif fault == "contiguity":
        args[0] = torch.zeros(H, 5).T
        err = ValueError
    else:
        args[4] = torch.zeros(2, H, device="meta")
        err = ValueError
    with pytest.raises(err):
        DR.rollout_b1(packed, *args, DT)


def test_packer_layout_is_pytorch_slices(case):
    """The packed (N, K) matrices are slices of the PyTorch weights."""
    _, dec, stats, _, _ = case
    packed = DR.pack_decoder(dec.cell, *_t(stats), weights_dtype=torch.float32)
    cell = dec.cell
    assert packed.kx % 8 == 0 and packed.kx >= POSE_IN
    torch.testing.assert_close(packed.wx[:H, :POSE_IN], cell.layer0.weight[:, :POSE_IN], rtol=0, atol=0)
    torch.testing.assert_close(packed.wx[H:, :POSE_IN], cell.gru0.weight_ih[:, H : H + POSE_IN], rtol=0, atol=0)
    assert torch.count_nonzero(packed.wx[:, POSE_IN:]) == 0
    torch.testing.assert_close(packed.wh[9 * H : 12 * H], cell.gru1.weight_hh, rtol=0, atol=0)
    torch.testing.assert_close(packed.wh[12 * H :], cell.out.weight, rtol=0, atol=0)
    torch.testing.assert_close(packed.stats[1], 1.0 / torch.as_tensor(stats[1]), rtol=0, atol=0)
