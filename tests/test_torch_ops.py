"""zeggs_tpu_torch.ops (quaternions, rot6d, FK) against zeggs_tpu.ops.

Inputs are made with numpy from a seed and given to both packages.
Tolerance: atol 1e-5 for single-expression float32 math; FK 1e-4,
because it accumulates rotations and offsets along chains of joints.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zeggs_tpu.ops import fk as jfk
from zeggs_tpu.ops import quat as jq
from zeggs_tpu.ops import xform as jx
from zeggs_tpu_torch.ops import fk as tfk
from zeggs_tpu_torch.ops import quat as tq
from zeggs_tpu_torch.ops import xform as tx

N = 64
RNG = np.random.default_rng(11)


@pytest.fixture(autouse=True)
def _seeded():
    """Every test draws its inputs from the same seed, whatever ran before."""
    global RNG
    RNG = np.random.default_rng(11)


def _unit_quats(n=N):
    q = RNG.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _vecs(n=N, scale=1.0):
    return (RNG.normal(size=(n, 3)) * scale).astype(np.float32)


def _small_vecs(n=N):
    """Half of them below the 1e-5 small-angle threshold of log/exp."""
    v = _vecs(n)
    v[: n // 2] *= 1e-7
    return v


def _close(ours, ref, atol=1e-5):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    np.testing.assert_allclose(ours, np.asarray(ref), atol=atol, rtol=0)


CASES = {
    "mul": (lambda: (_unit_quats(), _unit_quats()), jq.mul, tq.mul),
    "inv": (lambda: (_unit_quats(),), jq.inv, tq.inv),
    "mul_vec": (lambda: (_unit_quats(), _vecs()), jq.mul_vec, tq.mul_vec),
    "inv_mul_vec": (lambda: (_unit_quats(), _vecs()), jq.inv_mul_vec, tq.inv_mul_vec),
    "abs_": (lambda: (_unit_quats(),), jq.abs_, tq.abs_),
    "normalize": (lambda: (RNG.normal(size=(N, 4)).astype(np.float32),), jq.normalize, tq.normalize),
    "log": (lambda: (_unit_quats(),), jq.log, tq.log),
    "exp": (lambda: (_small_vecs(),), jq.exp, tq.exp),
    "to_helical": (lambda: (_unit_quats(),), jq.to_helical, tq.to_helical),
    "from_helical": (lambda: (_small_vecs(),), jq.from_helical, tq.from_helical),
    "between": (lambda: (_vecs(), _vecs()), jq.between, tq.between),
    "from_euler_zyx": (lambda: (_vecs(),), lambda e: jq.from_euler(e, "zyx"),
                       lambda e: tq.from_euler(e, "zyx")),
    "from_euler_xzy": (lambda: (_vecs(),), lambda e: jq.from_euler(e, "xzy"),
                       lambda e: tq.from_euler(e, "xzy")),
    "to_euler_zyx": (lambda: (_unit_quats(),), lambda q: jq.to_euler(q, "zyx"),
                     lambda q: tq.to_euler(q, "zyx")),
    "to_euler_xzy": (lambda: (_unit_quats(),), lambda q: jq.to_euler(q, "xzy"),
                     lambda q: tq.to_euler(q, "xzy")),
    "from_xform": (lambda: (np.array(jq.to_xform(jnp.asarray(_unit_quats()))),),
                   jq.from_xform, tq.from_xform),
    "orthogonalize_from_xy": (lambda: (RNG.normal(size=(N, 2, 3)).astype(np.float32),),
                              jx.orthogonalize_from_xy, tx.orthogonalize_from_xy),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    make, jfn, tfn = CASES[name]
    args = make()
    ref = jfn(*(jnp.asarray(a) for a in args))
    ours = tfn(*(torch.as_tensor(a) for a in args))
    assert tuple(ours.shape) == tuple(ref.shape)
    _close(ours, ref)


def test_exp_small_angle_branch_is_taken():
    v = np.full((4, 3), 1e-7, np.float32)
    ours = tq.exp(torch.as_tensor(v)).numpy()
    expected = np.concatenate([np.ones((4, 1)), v], axis=-1)
    expected /= np.linalg.norm(expected, axis=-1, keepdims=True) + 1e-5
    np.testing.assert_allclose(ours, expected, atol=1e-7, rtol=0)


def test_unroll_flips_exactly_where_jax_does():
    """A track with random sign flips: the port flips a frame exactly when
    its dot product with the aligned previous frame is negative."""
    q = _unit_quats(200).reshape(50, 4, 4)
    q = q * np.sign(RNG.normal(size=(50, 4, 1))).astype(np.float32)
    ref = np.asarray(jq.unroll(jnp.asarray(q)))
    ours = tq.unroll(torch.as_tensor(q)).numpy()
    np.testing.assert_array_equal(np.sign(ours), np.sign(ref))
    _close(ours, ref)


PARENTS = [-1, 0, 1, 2, 3, 4, 3, 6, 7, 3, 9, 10]


def _skeleton_state(T=16):
    J = len(PARENTS)
    lrot = _unit_quats(T * J).reshape(T, J, 4)
    lpos = (RNG.normal(size=(T, J, 3)) * 10).astype(np.float32)
    lvrt = _vecs(T * J).reshape(T, J, 3)
    lvel = _vecs(T * J, scale=5.0).reshape(T, J, 3)
    return lrot, lpos, lvrt, lvel


def test_fk_matches_jax():
    lrot, lpos, _, _ = _skeleton_state()
    ref = jfk.fk(jnp.asarray(lrot), jnp.asarray(lpos), PARENTS)
    ours = tfk.fk(torch.as_tensor(lrot), torch.as_tensor(lpos), PARENTS)
    for a, b in zip(ours, ref):
        _close(a, b, atol=1e-4)


def test_fk_vel_matches_jax():
    state = _skeleton_state()
    ref = jfk.fk_vel(*(jnp.asarray(a) for a in state), PARENTS)
    ours = tfk.fk_vel(*(torch.as_tensor(a) for a in state), PARENTS)
    for a, b in zip(ours, ref):
        _close(a, b, atol=1e-4)
