"""zeggs_tpu_torch.ops (quaternions, rot6d, FK) against zeggs_tpu.ops.

Inputs are made with numpy from a seed and given to both packages.
Tolerance: atol 1e-5 for single-expression float32 math; FK 1e-4,
because it accumulates rotations and offsets along chains of joints; 1e-4
for the rotation-matrix log and angle-axis (arccos near its ends) and for
the solves and iterative projections. `psolve` on a non-square matrix
solves a Gram system (x^T x or x x^T) + eps^2 I of rank min(m, n), singular
but for eps^2: those cases run at eps 0.3, where float32 can resolve it.
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


def _mats(n=N, *shape):
    return RNG.normal(size=(n, *shape)).astype(np.float32)


def _rotations(n=N):
    return np.array(jq.to_xform(jnp.asarray(_unit_quats(n))))


def _reflections(n=N):
    """Random matrices with a negative determinant."""
    m = _mats(n, 3, 3)
    m[np.linalg.det(m) > 0, :, 0] *= -1
    return m


def _homogeneous(n=N):
    m = _mats(n, 4, 4)
    m[:, 3, 3] = RNG.uniform(1.0, 2.0, n)
    return m


def _skeleton_args(n_frames=8):
    J = len(PARENTS)
    return (_unit_quats(n_frames * J).reshape(n_frames, J, 4),
            (RNG.normal(size=(n_frames, J, 3)) * 10).astype(np.float32))


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
    # quaternions
    "eye": (lambda: (), lambda: jq.eye((N,)), lambda: tq.eye((N,))),
    "inv_mul": (lambda: (_unit_quats(), _unit_quats()), jq.inv_mul, tq.inv_mul),
    "diff_world": (lambda: (_unit_quats(), _unit_quats()), jq.diff, tq.diff),
    "diff_local": (lambda: (_unit_quats(), _unit_quats()), lambda x, y: jq.diff(x, y, False),
                   lambda x, y: tq.diff(x, y, False)),
    "exp_np_style": (lambda: (_small_vecs(),), jq.exp_np_style, tq.exp_np_style),
    "quat_to_angle_axis": (lambda: (_unit_quats(),), jq.to_angle_axis, tq.to_angle_axis),
    "slerp": (lambda: (_unit_quats(), _unit_quats(), RNG.uniform(0, 1, N).astype(np.float32)),
              jq.slerp, tq.slerp),
    "to_xy": (lambda: (_unit_quats(),), jq.to_xy, tq.to_xy),
    "mul_scalar": (lambda: (_unit_quats(), RNG.uniform(0, 2, N).astype(np.float32)),
                   jq.mul_scalar, tq.mul_scalar),
    # rotation matrices and transforms
    "xform_mul": (lambda: (_mats(N, 3, 3), _mats(N, 3, 3)), jx.mul, tx.mul),
    "xform_mul_vec": (lambda: (_mats(N, 3, 3), _vecs()), jx.mul_vec, tx.mul_vec),
    "psolve_square": (lambda: (_mats(N, 3, 3) + 3 * np.eye(3, dtype=np.float32), _mats(N, 3, 2)),
                      jx.psolve, tx.psolve, 1e-4),
    "psolve_tall": (lambda: (_mats(N, 4, 3), _mats(N, 4, 2)),
                    lambda x, y: jx.psolve(x, y, eps=0.3), lambda x, y: tx.psolve(x, y, eps=0.3),
                    1e-4),
    "psolve_wide": (lambda: (_mats(N, 2, 3), _mats(N, 2, 4)),
                    lambda x, y: jx.psolve(x, y, eps=0.3), lambda x, y: tx.psolve(x, y, eps=0.3),
                    1e-4),
    "to_translation": (lambda: (_homogeneous(),), jx.to_translation, tx.to_translation),
    "to_rotation": (lambda: (_homogeneous(),), jx.to_rotation, tx.to_rotation),
    "to_rotation_translation": (lambda: (_homogeneous(),), jx.to_rotation_translation,
                                tx.to_rotation_translation),
    "from_rotation_translation": (lambda: (_mats(N, 3, 3), _vecs()),
                                  jx.from_rotation_translation, tx.from_rotation_translation),
    "xform_to_angle_axis": (lambda: (_rotations(),), jx.to_angle_axis, tx.to_angle_axis, 1e-4),
    "xform_from_angle_axis": (lambda: (RNG.uniform(-3, 3, N).astype(np.float32),
                                       _vecs() / np.linalg.norm(_vecs(), axis=-1, keepdims=True)),
                              jx.from_angle_axis, tx.from_angle_axis),
    "xform_log": (lambda: (_rotations(),), jx.log, tx.log, 1e-4),
    "xform_exp": (lambda: (_vecs(),), jx.exp, tx.exp),
    "from_basis": (lambda: (_vecs(), _vecs(), _vecs()), jx.from_basis, tx.from_basis),
    **{f"xform_from_euler_{o}": (lambda: (_vecs(),), lambda e, o=o: jx.from_euler(e, o),
                                 lambda e, o=o: tx.from_euler(e, o))
       for o in ("xzy", "xyz", "yxz", "yzx", "zyx", "zxy")},
    "orthogonalize_svd": (lambda: (_mats(N, 3, 3),), jx.orthogonalize, tx.orthogonalize, 1e-4),
    "orthogonalize_svd_reflection": (lambda: (_reflections(),), jx.orthogonalize,
                                     tx.orthogonalize, 1e-4),
    "orthogonalize_cross": (lambda: (_mats(N, 3, 3),), lambda x: jx.orthogonalize(x, "cross"),
                            lambda x: tx.orthogonalize(x, "cross")),
    # refining a rotation toward a noisy copy of itself (from the identity,
    # targets near a quarter turn make the torque step ill-conditioned)
    "orthogonalize_iterative": (lambda: (lambda r: (r + 0.05 * _mats(N, 3, 3), r))(_rotations()),
                                jx.orthogonalize_iterative, tx.orthogonalize_iterative, 1e-4),
    # kinematics
    "ik_rot": (lambda: (_skeleton_args()[0],), lambda g: jfk.ik_rot(g, PARENTS),
               lambda g: tfk.ik_rot(g, PARENTS)),
    "fk_root_position": (lambda: (*(a for a in _skeleton_args()[::-1]), _skeleton_args()[1]),
                         lambda p, g, l: jfk.fk_root_position(p, g, l, PARENTS),
                         lambda p, g, l: tfk.fk_root_position(p, g, l, PARENTS), 1e-4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    make, jfn, tfn, *atol = CASES[name]
    args = make()
    ref = jfn(*(jnp.asarray(a) for a in args))
    ours = tfn(*(torch.as_tensor(a) for a in args))
    if not isinstance(ref, tuple):
        ref, ours = (ref,), (ours,)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, *atol)


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
