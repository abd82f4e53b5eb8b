"""The GRU-cell kernel's plain version against zeggs_tpu's Pallas GRU cell
(interpret mode, as the JAX package's own tests run it on the CPU), at the
JAX tests' shapes.

Tolerance atol 2e-5, the budget of tests/test_pallas_kernels.py: the same
float32 equations with the biases folded the same way, summed in another
order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zeggs_tpu.models import layers as JL
from zeggs_tpu.ops.pallas import fused_gru_cell as jax_fused_gru_cell
from zeggs_tpu_torch.io import weights
from zeggs_tpu_torch.ops.kernels import build
from zeggs_tpu_torch.ops.kernels import gru_cell as GC

SHAPES = [(8, 384, 256), (16, 2304, 512)]


def _case(B, in_dim, H, seed=0):
    params = jax.tree.map(np.asarray, JL.gru_layer_init(jax.random.PRNGKey(seed), in_dim, H))
    cell = torch.nn.GRUCell(in_dim, H)
    cell.load_state_dict(weights.from_jax(params))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, in_dim)).astype(np.float32)
    h = rng.normal(size=(B, H)).astype(np.float32)
    return params, cell, x, h


@pytest.mark.parametrize("B,in_dim,H", SHAPES)
def test_plain_matches_pallas_gru_cell(B, in_dim, H):
    params, cell, x, h = _case(B, in_dim, H)
    ref = np.asarray(jax_fused_gru_cell(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                        jnp.asarray(h), tile_h=128, interpret=True))
    launches = build.launches()
    with torch.no_grad():
        ours = GC.fused_gru_cell(GC.pack_gru(cell), torch.as_tensor(x), torch.as_tensor(h))
    assert build.launches() == launches, "CPU tensors take the plain version and count no launch"
    assert tuple(ours.shape) == (B, H) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("B,in_dim,H", SHAPES)
def test_plain_matches_torch_gru_cell(B, in_dim, H):
    """Folding the r and z biases changes nothing beyond float32 rounding."""
    _, cell, x, h = _case(B, in_dim, H, seed=1)
    x, h = torch.as_tensor(x), torch.as_tensor(h)
    with torch.no_grad():
        torch.testing.assert_close(GC.gru_cell_plain(GC.pack_gru(cell), x, h), cell(x, h),
                                   atol=2e-5, rtol=0)


def test_pack_folds_biases_once():
    _, cell, _, _ = _case(2, 16, 8)
    with torch.no_grad():
        p = GC.pack_gru(cell)
    H = 8
    torch.testing.assert_close(p.b_rz, cell.bias_ih[: 2 * H] + cell.bias_hh[: 2 * H],
                               rtol=0, atol=0)
    assert torch.equal(p.b_in, cell.bias_ih[2 * H :]) and torch.equal(p.b_hn, cell.bias_hh[2 * H :])
    assert p.weight_ih.data_ptr() == cell.weight_ih.data_ptr(), "weights are not copied"


@pytest.mark.parametrize("fault", ["shape", "dtype", "contiguity", "device", "width"])
def test_wrapper_rejects_what_the_kernel_does_not_take(fault):
    _, cell, x, h = _case(4, 16, 8)
    cell.requires_grad_(False)  # the kernel is inference only
    p, x, h = GC.pack_gru(cell), torch.as_tensor(x), torch.as_tensor(h)
    err = ValueError
    if fault == "shape":
        h = h[:, :4].contiguous()
    elif fault == "dtype":
        x, err = x.double(), TypeError
    elif fault == "contiguity":
        x = torch.as_tensor(np.asfortranarray(x.numpy()))
    elif fault == "device":
        x = torch.zeros(4, 16, device="meta")
    else:
        cell = torch.nn.GRUCell(12, 8).requires_grad_(False)
        p, x = GC.pack_gru(cell), torch.zeros(4, 12)
    with pytest.raises(err):
        GC.fused_gru_cell(p, x, h)


# the shapes the kernel must take: B from 1 to the daemon's max_batch (64)
# with ragged tiles, the chip run's shapes and one row at full width
PLAN_SHAPES = [(1, 1024, 1024), (2, 1024, 1024), (3, 1024, 1024), (11, 1024, 1024),
               (64, 1024, 1024), (65, 1024, 1024), (8, 384, 256), (16, 2304, 512)]


@pytest.mark.parametrize("B,in_dim,H", PLAN_SHAPES)
def test_plan_covers_every_row_and_unit_once(B, in_dim, H):
    """Walk the launch as csrc/gru_cell.cu does: blocks own units, passes
    own batch tiles, and in a stage every (row, unit, column group) falls to
    exactly one lane of one warp. The weights leave L2 once a step for
    B <= 64."""
    plan = GC.gru_plan(B, in_dim, H)
    assert plan.blocks * GC.UNITS == H and B <= plan.tile * plan.passes
    assert plan.passes == (1 if B <= 64 else -(-B // 64))
    assert plan.smem_bytes <= 232448
    BG, KL, RB = plan.batch_lanes, plan.column_lanes, plan.rows_per_thread
    iters = plan.chunk // (4 * KL * GC.WARPS)
    assert BG * 2 * KL == 32 and iters * 4 * KL * GC.WARPS == plan.chunk
    stage = np.zeros((plan.tile, GC.UNITS, plan.chunk // 4), np.int32)
    for warp in range(GC.WARPS):
        for lane in range(32):
            bgi, ugi, kl = lane % BG, (lane // BG) % 2, lane // (2 * BG)
            for it in range(iters):
                for i in range(RB):
                    for q in range(4):
                        stage[bgi + BG * i, ugi * 4 + q, kl + KL * (warp + GC.WARPS * it)] += 1
    assert (stage == 1).all()
    outputs = np.zeros((B, H), np.int32)
    for block in range(plan.blocks):
        for b0 in range(0, B, plan.tile):
            for p in range(plan.tile * GC.UNITS):
                row, j = b0 + p // GC.UNITS, block * GC.UNITS + p % GC.UNITS
                if row < B:
                    outputs[row, j] += 1
    assert (outputs == 1).all()
    assert plan.chunks * plan.chunk >= in_dim + H
