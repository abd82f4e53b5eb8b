"""The inference decoder step's element-wise ops (`ops/kernels/decoder_step.py`)
on the CPU: the step that `models.decoder.chunk_step` gives runs each op's
plain version on CPU tensors, launches and counts no kernel, and equals,
bit for bit, the expressions the step computed before its element-wise math
had kernels (`models.pose.vectorize_input` / `devectorize_output`,
`models.layers.gru_gates`, the ELU and the FiLM scale and shift), for the
``normal``, ``film`` and int8 cells at B 1 and 3 on a narrow width. The
kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, ``-m cuda``).
"""

import pytest
import torch
import torch.nn.functional as F

from zeggs_tpu_torch.models import decoder as D
from zeggs_tpu_torch.models import layers as L
from zeggs_tpu_torch.models import pose as P
from zeggs_tpu_torch.ops.kernels import decoder_step as DS
from zeggs_tpu_torch.ops.kernels import gru_cell as GC
from zeggs_tpu_torch.utils import profiling

DT = 1.0 / 60.0
J, H, SPEECH, STYLE = 4, 16, 8, 6
OPS = {"normal": ["pose_in", "elu", "gru_gates", "pose_out"],
       "film": ["pose_in", "elu", "gru_gates", "elu", "pose_out"],
       "int8": ["pose_in", "pose_out"]}


def _case(cell, B, seed=0):
    """A narrow decoder, its statistics, one step's state and conditioning
    column, with a non-identity root; made from a seed."""
    pose_in, pose_out = 9 + 15 * J, 6 + 15 * J
    torch.manual_seed(seed)
    dec = D.Decoder(pose_in, pose_out, SPEECH, STYLE, H,
                    rnn_cond="film" if cell == "film" else "normal").eval()
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    stats = (r(pose_in, scale=0.1), r(pose_in).abs() + 0.5, r(pose_out, scale=0.1),
             r(pose_out).abs() * 0.2 + 0.05)
    q = r(B, 4)
    state = (r(B, H), r(B, H), r(B, 3), q / q.norm(dim=-1, keepdim=True), r(B, 3, scale=0.1),
             r(B, 3, scale=0.1), r(B, J, 3), r(B, J, 2, 3), r(B, J, 3, scale=0.1),
             r(B, J, 3, scale=0.1))
    return dec, stats, state, r(B, 3, scale=5.0), r(B, 1, SPEECH), r(B, 1, STYLE)


def _step_before(dec, cell, stats, gaze, cond, state):
    """One step as `chunk_step` computed it with PyTorch operators alone."""
    cp, (h0, h1, rp, rr, rv, rw, jp, jt, jv, jw) = dec.cell, state
    pose_dim = stats[0].shape[-1]
    w0, wg = cp.layer0.weight, cp.gru0.weight_ih
    w0_pose, wg_h, wg_pose = w0[:, :pose_dim], wg[:, :H], wg[:, H : H + pose_dim]
    pose = P.vectorize_input(rp, rr, rv, rw, jp, jt, jv, jw, gaze, stats[0], stats[1])
    l0_t, g0_t = cond[:2]
    if cell == "int8":
        qw = {k: D._quantize_weight(w) for k, w in (
            ("w0", w0_pose), ("wg_h", wg_h), ("wg_pose", wg_pose), ("whh0", cp.gru0.weight_hh),
            ("wih1", cp.gru1.weight_ih), ("whh1", cp.gru1.weight_hh), ("out", cp.out.weight))}
        pose_q = D._quantize_act(pose)
        hidden = L.elu(l0_t + D._qdot(pose_q, qw["w0"]))
        gi = g0_t + D._qdot(D._quantize_act(hidden), qw["wg_h"]) + D._qdot(pose_q, qw["wg_pose"])
        gh = D._qdot(D._quantize_act(h0), qw["whh0"]) + cp.gru0.bias_hh
        h0_new = L.gru_gates(gi, gh, h0)
        gi1 = D._qdot(D._quantize_act(h0_new), qw["wih1"]) + cp.gru1.bias_ih
        gh1 = D._qdot(D._quantize_act(h1), qw["whh1"]) + cp.gru1.bias_hh
        h1_new = L.gru_gates(gi1, gh1, h1)
        out = D._qdot(D._quantize_act(h1_new), qw["out"]) + cp.out.bias
    else:
        hidden = L.elu(l0_t + pose @ w0_pose.T)
        if cell == "film":
            gammas, betas = cond[2:]
            hidden = hidden * gammas[:, :H] + betas[:, :H]
        gi = g0_t + hidden @ wg_h.T + pose @ wg_pose.T
        h0_new = L.gru_gates(gi, F.linear(h0, cp.gru0.weight_hh, cp.gru0.bias_hh), h0)
        h1_new = GC.gru_cell_plain(GC.pack_gru(cp.gru1), h0_new, h1)
        top = h1_new
        if cell == "film":
            top = L.elu(F.linear(h1_new, cp.layer2.weight, cp.layer2.bias)) * gammas[:, H:] \
                + betas[:, H:]
        out = F.linear(top, cp.out.weight, cp.out.bias)
    return (h0_new, h1_new) + P.devectorize_output(out, rp, rr, J, DT, stats[2], stats[3])


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("cell", ["normal", "film", "int8"])
def test_cpu_step_runs_the_plain_ops_bit_for_bit(cell, B, monkeypatch):
    dec, stats, state, gaze, speech, style = _case(cell, B)
    calls = []
    for name in set(OPS[cell]):
        op = getattr(DS.PlainOps, name)
        monkeypatch.setattr(DS.PlainOps, name,
                            staticmethod(lambda *a, _op=op, _n=name, **k: (calls.append(_n),
                                                                           _op(*a, **k))[1]))
    with torch.inference_mode():
        conditioning, step, plain = D.chunk_step(dec, *stats, DT, J,
                                                 quantize_int8=cell == "int8")
        cond = tuple(c[:, 0] for c in conditioning(speech, style))
        before = profiling.counters().get("decoder_step.launches", 0)
        got = step(gaze, *cond, *state)
        want = _step_before(dec, cell, stats, gaze, cond, state)
    assert not plain and DS.step_ops(state[2], plain) is DS.PlainOps
    assert calls == OPS[cell]
    assert profiling.counters().get("decoder_step.launches", 0) == before
    assert len(got) == len(want) == 10
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.equal(g, w), i


def test_the_kernels_take_only_cuda_tensors():
    """The kernels' wrappers have no CPU fall-back: CPU tensors raise before
    anything is built or launched."""
    _, stats, state, gaze, _, _ = _case("normal", 2)
    h0, h1, rp, rr, *local = state
    with pytest.raises(TypeError):
        DS.CudaOps.pose_in(rp, rr, *local, gaze, stats[0], stats[1])
    with pytest.raises(TypeError):
        DS.CudaOps.elu(h0, h1)
    with pytest.raises(TypeError):
        DS.CudaOps.pose_out(torch.zeros(2, 6 + 15 * J), rp, rr, J, DT, stats[2], stats[3])
    # a step that autograd records, or another compute dtype, stays plain
    assert DS.step_ops(rp, True) is DS.PlainOps
    assert DS.step_ops(rp.double(), False) is DS.PlainOps
