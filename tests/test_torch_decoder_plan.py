"""The decoder kernel's host-side plan (`plan_rollout`) and its phase
schedule, on the CPU.

The plan must give every packed row to exactly one block, keep every block
within its shared memory, and keep the int8 cell wholly resident at the v1
widths on an H100's 132 SMs. A plain PyTorch simulation of the kernel's
schedule, driven by the plan's tables (the hidden-state products moved to
phases 3 and 4 of the step before, the GRU products kept per block), equals
`rollout_b1_plain` at fp32 weights within 1e-5: the same products in
another order of float32 sums.
"""

import numpy as np
import pytest
import torch

from zeggs_tpu_torch.models import decoder as D
from zeggs_tpu_torch.models.layers import gru_gates
from zeggs_tpu_torch.ops import quat
from zeggs_tpu_torch.ops.kernels import decoder_rollout as DR

V1 = dict(hidden=1024, kx=1136, pose_out=1131)  # 75 joints: pose in 1134 -> 1136
DTYPES = [torch.float32, torch.bfloat16, torch.int8]
HDR = 12


def _phase(plan, b, p):
    """(packed rows, shared-memory offsets, streamed indices) of block b."""
    t, mr = plan.table[b].numpy(), plan.mr
    n, ns = t[p], t[4 + p]
    row = HDR + 3 * mr * p
    return t[row : row + n], t[row + mr : row + mr + n], t[row + 2 * mr : row + 2 * mr + ns]


# fp32 at v1 widths does not fit 120 KB: see test_plan_raises_when_it_cannot_fit
@pytest.mark.parametrize("dtype,budget", [(d, DR.SMEM_BUDGET) for d in DTYPES]
                         + [(torch.bfloat16, 120_000), (torch.int8, 120_000)])
def test_plan_assigns_every_row_once_within_budget(dtype, budget):
    H, kx, PO = V1["hidden"], V1["kx"], V1["pose_out"]
    plan = DR.plan_rollout(H, kx, PO, dtype, blocks=132, smem_budget=budget)
    es = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[dtype]
    rb = [kx * es] + [H * es] * 3
    seen = [np.zeros(4 * H, np.int32), np.zeros(12 * H + PO, np.int32)]
    resident = streamed = 0
    for b in range(plan.blocks):
        hdr = plan.table[b, :HDR].tolist()
        res_end, staging = hdr[10], hdr[11]
        assert plan.base <= res_end and res_end + staging <= budget
        spans = []
        for p in range(4):
            glob, off, stream = _phase(plan, b, p)
            np.add.at(seen[min(p, 1)], glob, 1)
            staged = set(stream.tolist())
            assert len(staged) == len(stream)
            for i, o in enumerate(off.tolist()):
                if i in staged:
                    assert res_end <= o and o + rb[p] <= res_end + staging
                    streamed += rb[p]
                else:
                    spans.append((o, o + rb[p]))
                    resident += rb[p]
        spans.sort()
        assert all(a1 <= b0 for (_, a1), (b0, _) in zip(spans, spans[1:])), "resident rows overlap"
        assert not spans or (spans[0][0] >= plan.base and spans[-1][1] <= res_end)
    assert (seen[0] == 1).all() and (seen[1] == 1).all()
    assert resident == plan.resident_bytes and streamed == plan.streamed_bytes
    assert resident + streamed == plan.weight_bytes
    counts = np.array([[plan.table[b, p].item() for p in range(4)] for b in range(plan.blocks)])
    assert (counts.max(0) - counts.min(0) <= [1, 3, 3, 1]).all(), "phases are balanced"
    # the rebalanced phases: 4H, 3H, 6H and PO + 3H rows
    assert counts.sum(0).tolist() == [4 * H, 3 * H, 6 * H, PO + 3 * H]


def test_int8_is_wholly_resident_at_v1_widths():
    plan = DR.plan_rollout(**V1, weights_dtype=torch.int8, blocks=132)
    assert plan.resident_share == 1.0 and plan.streamed_bytes == 0
    bf16 = DR.plan_rollout(**V1, weights_dtype=torch.bfloat16, blocks=132)
    f32 = DR.plan_rollout(**V1, weights_dtype=torch.float32, blocks=132)
    assert 0.6 < bf16.resident_share < 1.0 and 0.1 < f32.resident_share < bf16.resident_share


@pytest.mark.parametrize("hidden,budget", [(2048, DR.SMEM_BUDGET), (1024, 60_000)])
def test_plan_raises_when_it_cannot_fit(hidden, budget):
    with pytest.raises(ValueError, match="does not fit"):
        DR.plan_rollout(hidden, 1136, 1131, torch.float32, blocks=132, smem_budget=budget)


def _simulate(packed, plan, cond_l0, cond_g0, gaze, p0, h_init, root0, dt):
    """The kernel's schedule in plain PyTorch (fp32 weights), block by
    block from the plan's tables."""
    H, PI, PO = packed.hidden, packed.pose_in, packed.pose_out
    G = 3 * H
    w = [packed.wx.float(), packed.wh.float()]
    in_mean, in_rstd = packed.stats[0], packed.stats[1]
    out_std, out_mean = packed.stats[2, :PO], packed.stats[3, :PO]
    b_hh0, b_ih1, b_hh1 = packed.gbias
    blocks = range(plan.blocks)
    glob = {(b, p): torch.as_tensor(_phase(plan, b, p)[0], dtype=torch.long)
            for b in blocks for p in range(4)}
    n0 = {b: plan.table[b, 8].item() for b in blocks}
    n1 = {b: plan.table[b, 9].item() for b in blocks}
    dots = {}

    def phase(p, act):
        for b in blocks:
            dots[b, p] = w[min(p, 1)][glob[b, p]] @ act

    phase(2, h_init[0])  # before step 0: W_g0hh h0 and W_g1hh h1 of the initial state
    phase(3, h_init[1])
    pose, h0, h1, rp, rq = p0, h_init[0], h_init[1], root0[:3], root0[3:7]
    rows = []
    for t in range(cond_l0.shape[0]):
        gd = quat.inv_mul_vec(rq, gaze[t] - rp)
        x = torch.zeros(packed.kx)
        x[:PI] = (torch.cat([pose, gd]) - in_mean) * in_rstd
        phase(0, x)
        l0 = torch.zeros(H)
        for b in blocks:
            l0[glob[b, 0][3 * n0[b] :]] = dots[b, 0][3 * n0[b] :]
        pre = cond_l0[t] + l0
        phase(1, torch.where(pre > 0.0, pre, torch.exp(pre) - 1.0))
        h0n = torch.zeros(H)
        for b in blocks:
            j = glob[b, 1][0 : 3 * n0[b] : 3]
            gi = torch.stack([(cond_g0[t][g * H + j] + dots[b, 0][g : 3 * n0[b] : 3])
                              + dots[b, 1][g::3] for g in range(3)])
            gh = torch.stack([dots[b, 2][3 * n1[b] + g :: 3] + b_hh0[g * H + j] for g in range(3)])
            h0n[j] = _gates(gi, gh, h0[j])
        h0 = h0n
        phase(2, h0)
        h1n = torch.zeros(H)
        for b in blocks:
            j = glob[b, 2][0 : 3 * n1[b] : 3] - 2 * G
            gi = torch.stack([dots[b, 2][g : 3 * n1[b] : 3] + b_ih1[g * H + j] for g in range(3)])
            gh = torch.stack([dots[b, 3][g : 3 * n1[b] : 3] + b_hh1[g * H + j] for g in range(3)])
            h1n[j] = _gates(gi, gh, h1[j])
        h1 = h1n
        phase(3, h1)
        pose = torch.zeros(PO)
        for b in blocks:
            c = glob[b, 3][3 * n1[b] :] - 4 * G
            pose[c] = (dots[b, 3][3 * n1[b] :] + packed.bout[c]) * out_std[c] + out_mean[c]
        rp = rp + quat.mul_vec(rq, pose[0:3] * dt)
        rq = quat.mul(DR._from_helical(quat.mul_vec(rq, pose[3:6] * dt)), rq)
        rows.append(torch.cat([pose, rp, rq]))
    return torch.stack(rows)


def _gates(gi, gh, h):
    """`gru_gates` on (3, n) gate rows."""
    return gru_gates(torch.cat(list(gi)), torch.cat(list(gh)), h)


@pytest.mark.parametrize("budget", [DR.SMEM_BUDGET, 16_000])
@torch.no_grad()
def test_planned_schedule_equals_plain(budget):
    njoints, H, T1 = 4, 32, 6
    pose_in, pose_out = 6 + 15 * njoints + 3, 6 + 15 * njoints
    torch.manual_seed(0)
    dec = D.Decoder(pose_in, pose_out, 16, 16, H).eval()
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    stats = (t(rng.normal(size=pose_in) * 0.1), t(rng.uniform(0.5, 2.0, pose_in)),
             t(rng.normal(size=pose_out) * 0.1), t(rng.uniform(0.05, 0.5, pose_out)))
    packed = DR.pack_decoder(dec.cell, *stats, weights_dtype=torch.float32)
    plan = DR.plan_rollout(H, packed.kx, pose_out, torch.float32, blocks=5, smem_budget=budget)
    assert (plan.streamed_bytes > 0) == (budget < DR.SMEM_BUDGET)
    q = rng.normal(size=4)
    args = (t(rng.normal(size=(T1, H))), t(rng.normal(size=(T1, 3 * H))),
            t(rng.normal(size=(T1, 3))), t(rng.normal(size=pose_out) * 0.3),
            t(rng.normal(size=(2, H)) * 0.5), t(np.concatenate([rng.normal(size=3), q / np.linalg.norm(q)])))
    ours = _simulate(packed, plan, *args, 1 / 60)
    ref = DR.rollout_b1_plain(packed, *args, 1 / 60)
    assert ours.shape == ref.shape == (T1, pose_out + 7)
    torch.testing.assert_close(ours, ref, atol=1e-5, rtol=0)
