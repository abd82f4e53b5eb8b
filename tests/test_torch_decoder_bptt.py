"""The decoder's training rollout as one autograd Function
(`ops/kernels/decoder_train.py`): its backward through time, written by
hand, against autograd through the plain step, and where it is engaged.
Imports no jax; the `cuda` tests run on a machine with a card as

    python -m pytest --noconftest -m cuda tests/test_torch_decoder_bptt.py

and skip elsewhere (inside the fixture).

Tolerances. On the CPU in float64 the two differ only in the order of
sums, 1e-10 of each output's and each gradient's scale. In float32, and
on the card (kernels against their plain versions, the Function against
its plain version), the same order-of-sums difference at float32: a step
op 1e-5 of its scale, a whole window's outputs and gradients 1e-4, the
train-step gradient budget of tests/test_torch_cuda.py (per leaf 1e-4 *
max(1, max|g|)).
"""

from collections import Counter

import numpy as np
import pytest
import torch

from zeggs_tpu_torch.models import decoder as D
from zeggs_tpu_torch.ops import quat
from zeggs_tpu_torch.ops.kernels import build
from zeggs_tpu_torch.ops.kernels import decoder_train as DT
from zeggs_tpu_torch.ops.kernels import gru_cell as GC
from zeggs_tpu_torch.utils import profiling

DT_S = 1.0 / 60.0


def _case(J=3, S=5, C=4, H=8, B=3, T=6, dtype=torch.float64, still_root=False, device="cpu",
          seed=0):
    """A decoder of PyTorch's initialisation, pose statistics, a frame-0
    state and the window's conditioning (B, T + 1, ...), from a seed.
    ``still_root``: the root's angular velocity comes out ~1e-10 rad a
    frame, so that `quat.from_helical` takes its small-angle branch."""
    pin, pout = 6 + 15 * J + 3, 6 + 15 * J
    torch.manual_seed(seed)
    dec = D.Decoder(pin, pout, S, C, H).to(device=device, dtype=dtype)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

    std_out = rng.uniform(0.05, 0.5, pout)
    mean_out = rng.normal(size=pout) * 0.1
    if still_root:
        std_out[3:6], mean_out[3:6] = 1e-10, 0.0
    stats = (t(rng.normal(size=pin) * 0.1), t(rng.uniform(0.5, 2.0, pin)), t(mean_out),
             t(std_out))
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    state = [t(rng.normal(size=(B, 3))), t(q), t(rng.normal(size=(B, 3))),
             t(rng.normal(size=(B, 3)) * 3), t(rng.normal(size=(B, J, 3))),
             t(rng.normal(size=(B, J, 2, 3))), t(rng.normal(size=(B, J, 3))),
             t(rng.normal(size=(B, J, 3)))]
    cond = [t(rng.normal(size=(B, T + 1, 3)) * 5), t(rng.normal(size=(B, T + 1, S))),
            t(rng.normal(size=(B, T + 1, C)))]
    return dec, stats, state, cond


def _weights_like(outs, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=o.shape), dtype=o.dtype, device=o.device)
            for o in outs]


def _chunk(dec, stats, state, cond, carry_grad, bptt):
    """Outputs and gradients of a weighted sum of the window's trajectories
    and new carry: through the Function (``bptt``) or autograd through the
    plain step (compute_dtype = the state's dtype)."""
    leaves = list(state) + list(cond)
    for x in leaves:
        x.grad = None
        x.requires_grad_(carry_grad)
    for p in dec.parameters():
        p.grad = None
    gaze, speech, style = cond
    carry = D.init_carry(dec, *state, gaze[:, 0], style[:, 0], stats[0], stats[1])
    J = state[4].shape[1]
    dtype = state[0].dtype
    if bptt:
        conditioning, _, _ = D.chunk_step(dec, *stats, DT_S, J, compute_dtype=dtype)
        pre_l0, pre_g0 = conditioning(speech[:, 1:], style[:, 1:])
        new_carry, ys = DT.rollout_bptt(dec.cell, carry, gaze[:, 1:], pre_l0, pre_g0, *stats,
                                        DT_S)
    else:
        new_carry, ys = D.rollout_chunk(dec, carry, gaze[:, 1:], speech[:, 1:], style[:, 1:],
                                        *stats, DT_S, compute_dtype=dtype)
    outs = list(ys) + list(new_carry)
    loss = sum((o * w).sum() for o, w in zip(outs, _weights_like(outs)))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in dec.named_parameters()}
    if carry_grad:
        grads.update({f"leaf{i}": x.grad.clone() for i, x in enumerate(leaves)})
    return [o.detach() for o in outs], grads


def _close(a, b, tol):
    scale = max(1.0, b.abs().max().item())
    return (a - b).abs().max().item() <= tol * scale


@pytest.mark.parametrize("frames", [2, 8])
@pytest.mark.parametrize("carry_grad", [True, False])
@pytest.mark.parametrize("still_root", [False, True])
def test_plain_bptt_matches_autograd_through_the_plain_step(frames, carry_grad, still_root):
    """float64, small widths: the same outputs and the same gradient for
    every parameter and, where the carry and conditioning need one, every
    input, with the carry from the cell-state encoder (which needs a
    gradient in every case)."""
    case = _case(T=frames, still_root=still_root)
    outs_ref, grads_ref = _chunk(*case, carry_grad, bptt=False)
    outs, grads = _chunk(*case, carry_grad, bptt=True)
    assert len(outs) == len(outs_ref) == 17
    for a, b in zip(outs, outs_ref):
        assert a.shape == b.shape and _close(a, b, 1e-10)
    assert set(grads) == set(grads_ref)
    for k, g in grads_ref.items():
        assert _close(grads[k], g, 1e-10), k


@pytest.mark.parametrize("halfangle", [3e-6, 0.3, 2.0])
def test_quaternion_exp_backward_matches_autograd(halfangle):
    """`from_helical`'s exp map on both sides of its eps: the hand-written
    backward against autograd through `quat.exp` (float64)."""
    rng = np.random.default_rng(3)
    d = rng.normal(size=(5, 3))
    x = torch.tensor(d / np.linalg.norm(d, axis=-1, keepdims=True) * halfangle,
                     requires_grad=True)
    g = torch.tensor(rng.normal(size=(5, 4)))
    (quat.exp(x) * g).sum().backward()
    assert torch.allclose(DT._exp_bwd(x.detach(), g), x.grad, rtol=0, atol=1e-12)


def _bptt_counts():
    c = profiling.counters()
    return c.get("decoder_bptt.forwards", 0), c.get("decoder_bptt.backwards", 0)


def _launches():
    return build.launches()["decoder_train"]


def _captured(launches):
    """What a graph of one window's gradient captured: its kernel launches
    and one pass each way."""
    return Counter({"decoder_train.launches": launches, "decoder_bptt.forwards": 1,
                    "decoder_bptt.backwards": 1})


def _rollout(dec, stats, state, cond, **kw):
    gaze, speech, style = cond
    return D.rollout(dec, *state, gaze, speech, style, *stats, DT_S, **kw)


def test_the_train_rollout_goes_through_the_function():
    """A float32 rollout under autograd runs the Function once forward and
    once backward, and equals today's step (remat: the same plain step,
    recomputed) to float32's order of sums."""
    dec, stats, state, cond = _case(dtype=torch.float32, T=5)
    results = []
    for remat in (False, True):
        before = _bptt_counts()
        for p in dec.parameters():
            p.grad = None
        outs = _rollout(dec, stats, state, cond, remat=remat)
        loss = sum((o * w).sum() for o, w in zip(outs, _weights_like(outs)))
        loss.backward()
        forwards, backwards = (a - b for a, b in zip(_bptt_counts(), before))
        assert (forwards, backwards) == ((0, 0) if remat else (1, 1))
        results.append((outs, {n: p.grad.clone() for n, p in dec.named_parameters()}))
    (outs, grads), (outs_ref, grads_ref) = results
    for a, b in zip(outs, outs_ref):
        assert _close(a.detach(), b.detach(), 1e-5)
    for k, g in grads_ref.items():
        assert _close(grads[k], g, 1e-4), k


@pytest.mark.parametrize("option", ["no_grad", "bfloat16", "remat", "film", "int8",
                                    "output_indices"])
def test_the_function_is_not_engaged(option, monkeypatch):
    """Every other case keeps the plain step or the inference step: the
    Function never runs and its counters stay where they were."""
    def refuse(*_, **__):
        raise AssertionError("DecoderBPTT engaged")

    monkeypatch.setattr(DT.DecoderBPTT, "apply", refuse)
    grad = option not in ("no_grad", "int8")  # inference runs float32, as the kernels do
    dec, stats, state, cond = _case(T=3, dtype=torch.float64 if grad else torch.float32)
    if option == "film":
        dec = D.Decoder(6 + 15 * 3 + 3, 6 + 15 * 3, 5, 4, 8, rnn_cond="film").double()
    kw = {"no_grad": {}, "bfloat16": {"compute_dtype": torch.bfloat16}, "remat": {"remat": True},
          "film": {}, "int8": {"quantize_int8": True},
          "output_indices": {"output_indices": (0, 1, 4)}}[option]
    before = _bptt_counts()
    with torch.set_grad_enabled(grad):
        outs = _rollout(dec, stats, state, cond, **kw)
    if grad:
        sum(o.float().sum() for o in outs).backward()
    assert _bptt_counts() == before


def test_the_inference_step_is_unchanged(monkeypatch):
    """Under no_grad `chunk_step` gives the inference step (GRU1 through
    the GRU-cell kernel's wrapper, its plain version on the CPU), which
    neither the Function nor its counters see, and which computes what the
    Function's forward computes."""
    dec, stats, state, cond = _case(dtype=torch.float32, T=4)
    calls = []
    real = GC.fused_gru_cell
    monkeypatch.setattr(GC, "fused_gru_cell", lambda *a: calls.append(1) or real(*a))
    before = _bptt_counts()
    with torch.no_grad():
        _, _, plain = D.chunk_step(dec, *stats, DT_S, 3)
        inference = _rollout(dec, stats, state, cond)
    assert not plain and len(calls) == 4 and _bptt_counts() == before
    train = _rollout(dec, stats, state, cond)
    assert _bptt_counts() == (before[0] + 1, before[1])
    for a, b in zip(inference, train):
        assert _close(a, b.detach(), 1e-5)


def test_counts_of_captured_passes_add_at_each_replay():
    """A graph's captured launches and passes count once for each replay."""
    launches, before = _launches(), _bptt_counts()
    counts = Counter({"decoder_train.launches": 12, "decoder_bptt.forwards": 1,
                      "decoder_bptt.backwards": 1})
    assert counts - Counter({"decoder_train.launches": 2, "decoder_bptt.forwards": 1}) == \
        Counter({"decoder_train.launches": 10, "decoder_bptt.backwards": 1})
    for _ in range(3):
        profiling.replayed(counts)
    assert _launches() == launches + 36
    assert _bptt_counts() == (before[0] + 3, before[1] + 3)


def test_the_train_program_counts_its_passes_on_the_cpu():
    """Each eager step of a `TrainProgram` on the CPU runs the Function
    once each way, and launches no kernel."""
    from zeggs_tpu_torch.train.programs import TrainProgram
    from zeggs_tpu_torch.train.radam import RAdam, exponential_step_schedule

    dec, stats, state, cond = _case(dtype=torch.float32, T=4)
    params = dict(dec.named_parameters())
    optimizer = RAdam(params, exponential_step_schedule(1e-4, 0.995, every=1000))

    def loss_fn(nets, batch, iteration, generator=None):
        outs = _rollout(nets["decoder"], stats, state, cond)
        return sum((o ** 2).mean() for o in outs), {"total_loss": outs[0].sum().detach()}

    program = TrainProgram(loss_fn, {"decoder": dec}, optimizer)
    launches, before = build.launches(), _bptt_counts()
    for i in range(3):
        program.run({"x": np.zeros(2, np.float32)}, i)
    assert _bptt_counts() == (before[0] + 3, before[1] + 3) and build.launches() == launches


# -- on the card ------------------------------------------------------------

@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


#: (B, T, H, joints): the v1 train cell's window and a ragged small one
SHAPES = {"cell": (32, 256, 1024, 75), "ragged": (3, 5, 40, 5)}


def _rand(rng, *shape, scale=1.0, device="cuda"):
    return torch.as_tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=device)


def _op_cases(B, H, J, device):
    """{op: (args for `PlainOps` / `CudaOps`, indices of the written args)}
    at one frame, with the strided (B, T, ...) frame views the Function
    passes (T = 3, frame 1)."""
    rng = np.random.default_rng(5)
    D, T = 6 + 15 * J, 3
    Din = D + 3

    def r(*shape, scale=1.0):
        return _rand(rng, *shape, scale=scale, device=device)

    def frame(n, scale=1.0):
        return r(B, T, n, scale=scale)[:, 1]

    def quats(n=B):
        q = r(n, 4)
        return q / q.norm(dim=-1, keepdim=True)

    mean_in, std_in = r(Din, scale=0.1), r(Din).abs() + 0.5
    mean_out, std_out = r(D, scale=0.1), r(D).abs() * 0.2 + 0.05
    mean_out[3:6] = 0.0
    # row 0 of the last frame's output: no root rotation, so that the exp
    # map takes its small-angle branch there
    out = r(B, D)
    out[0, 3:6] = 0.0
    p_prev = frame(D)
    p_prev[0, 3:6] = 1e-9
    gates = torch.cat([torch.rand(B, 3 * H, device=device), r(B, H)], dim=1)
    gates[:, 2 * H : 3 * H] = gates[:, 2 * H : 3 * H] * 2 - 1
    a4 = r(B, 4 * H)

    def outs(*shapes):
        return [torch.full(s, float("nan"), device=device) for s in shapes]

    p_dst, rp_dst, rr_dst = (x[:, 1] for x in outs((B, T, D), (B, T, 3), (B, T, 4)))
    pose_dst, = outs((B, Din))
    cases = {
        "pose_fwd": ((out, mean_out, std_out, None, r(B, 3), quats(), p_dst, rp_dst, rr_dst,
                      frame(3, 5.0), mean_in, std_in, pose_dst, DT_S), (6, 7, 8, 12)),
        "pose_fwd_first": ((None, mean_out, std_out, r(B, D), r(B, 3), quats(), None, None, None,
                            frame(3, 5.0), mean_in, std_in, pose_dst.clone(), DT_S), (12,)),
        "pose_fwd_last": ((r(B, D), mean_out, std_out, None, r(B, 3), quats(), p_dst.clone(),
                           rp_dst.clone(), rr_dst.clone(), None, mean_in, std_in, None, DT_S),
                          (6, 7, 8)),
        "elu_fwd": ((frame(H), a4[:, :H], *outs((B, H), (B, H))), (2, 3)),
        "gru_fwd_l0": ((frame(3 * H), r(B, 3 * H), a4[:, H:], r(B, 3 * H), r(B, 2 * H)[:, :H],
                        *outs((B, H), (B, 4 * H))), (5, 6)),
        "gru_fwd_l1": ((r(B, 3 * H), None, None, r(B, 3 * H), r(B, H), *outs((B, H), (B, 4 * H))),
                       (5, 6)),
        "gru_bwd": ((r(B, H), gates, r(B, H), outs((B, 4 * H))[0][:, H:], outs((B, 3 * H))[0]),
                    (0, 3, 4)),
        "elu_bwd": ((r(B, H), r(B, H, scale=3.0), outs((B, 4 * H))[0][:, :H]), (2,)),
        "pose_bwd": ((r(B, Din), std_in, frame(3, 5.0), r(B, 3), quats(), frame(3), frame(D),
                      frame(3), frame(4), p_prev, quats(), std_out, outs((B, D))[0], r(B, 3),
                      r(B, 4), None, DT_S), (5, 12, 13, 14)),
        "pose_bwd_last": ((None, std_in, None, r(B, 3), quats(), None, frame(D), frame(3),
                           frame(4), frame(D), quats(), std_out, outs((B, D))[0], r(B, 3),
                           r(B, 4), None, DT_S), (12, 13, 14)),
        "pose_bwd_first": ((r(B, Din), std_in, frame(3, 5.0), r(B, 3), quats(), frame(3), None,
                            None, None, None, None, std_out, None, r(B, 3), r(B, 4),
                            outs((B, D))[0], DT_S), (5, 13, 14, 15)),
    }
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_each_kernel_matches_its_plain_version(device, shape):
    """Every kernel, forward and backward, at the cell's shapes and at a
    ragged small one, against its plain version on the same inputs on the
    card: 1e-5 of each output's scale."""
    B, _, H, J = SHAPES[shape]
    launches = _launches()
    for name, (args, written) in _op_cases(B, H, J, device).items():
        op = name.split("_first")[0].split("_last")[0].replace("_l0", "").replace("_l1", "")
        plain = [a.clone() if torch.is_tensor(a) and i in written else a
                 for i, a in enumerate(args)]
        getattr(DT.PlainOps, op)(*plain)
        getattr(DT.CudaOps, op)(*args)
        torch.cuda.synchronize()
        for i in written:
            assert torch.isfinite(args[i]).all(), (name, i)
            assert _close(args[i], plain[i], 1e-5), (name, i)
    assert _launches() == launches + 11


def _window(shape, device, seed=0):
    B, T, H, J = SHAPES[shape]
    return _case(J=J, S=64, C=64, H=H, B=B, T=T - 1, dtype=torch.float32, device=device,
                 seed=seed)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_function_on_the_card_matches_its_plain_version(device, shape, monkeypatch):
    """The whole window through the kernels and through the plain ops on
    the card: outputs and every gradient within 1e-4 of their scale; the
    kernels ran 8 launches a frame and 2 more, none in the plain run."""
    case = _window(shape, device)
    T = SHAPES[shape][1] - 1
    launches = _launches()
    outs, grads = _chunk(*case, True, bptt=True)
    torch.cuda.synchronize()
    assert _launches() - launches == 8 * T + 2
    monkeypatch.setattr(DT, "step_ops", lambda _device: DT.PlainOps)
    launches = _launches()
    outs_ref, grads_ref = _chunk(*case, True, bptt=True)
    torch.cuda.synchronize()
    assert _launches() == launches
    for a, b in zip(outs, outs_ref):
        assert _close(a, b, 1e-4)
    for k, g in grads_ref.items():
        assert torch.isfinite(grads[k]).all() and _close(grads[k], g, 1e-4), k


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_train_program_replays_the_kernels(device, shape):
    """A `TrainProgram` on the card: its eager first step launches the
    kernels, its capture records them, and every replay counts them and
    one pass each way (at the v1 train cell's shape, 8 x 255 + 1
    launches); the replays' losses equal the eager steps'."""
    from zeggs_tpu_torch.train.programs import TrainProgram
    from zeggs_tpu_torch.train.radam import RAdam, exponential_step_schedule

    dec, stats, state, cond = _window(shape, device)
    T = SHAPES[shape][1] - 1

    def loss_fn(nets, batch, iteration, generator=None):
        outs = _rollout(nets["decoder"], stats, state, cond)
        loss = sum((o ** 2).mean() for o in outs)
        return loss, {"total_loss": loss.detach()}

    params0 = {k: p.detach().clone() for k, p in dec.named_parameters()}
    optimizer = RAdam(dict(dec.named_parameters()),
                      exponential_step_schedule(1e-4, 0.995, every=1000))
    prog = TrainProgram(loss_fn, {"decoder": dec}, optimizer)
    per_step = 8 * T + 1  # frame 0's pose is data: no input product nor pose kernel there
    losses = []
    for i in range(4):
        launches, passes = _launches(), _bptt_counts()
        losses.append(prog.run({"x": np.zeros(2, np.float32)}, i)["total_loss"].item())
        torch.cuda.synchronize()
        assert _launches() - launches == per_step, i
        assert _bptt_counts() == (passes[0] + 1, passes[1] + 1), i
    assert len(prog.graphs) == 1 and prog.counts == _captured(per_step)
    # the same four steps eagerly, from the same weights
    with torch.no_grad():
        for k, p in dec.named_parameters():
            p.copy_(params0[k])
    eager = RAdam(dict(dec.named_parameters()), exponential_step_schedule(1e-4, 0.995, every=1000))
    for i in range(4):
        for p in dec.parameters():
            p.grad = None
        loss, _ = loss_fn({"decoder": dec}, None, i)
        loss.backward()
        eager.step()
        assert loss.item() == pytest.approx(losses[i], rel=1e-5), i
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_the_profilers_graph_counts_the_kernels(device):
    """A profiler's captured section (`profilers.common.Graphed`) that holds
    the training rollout's gradient counts, at each replay, its launches
    and one pass each way."""
    from zeggs_tpu_torch.profilers.common import Graphed

    dec, stats, state, cond = _window("ragged", device)
    per_window = 8 * (SHAPES["ragged"][1] - 1) + 1  # frame 0's pose is data
    params = list(dec.parameters())

    def section():
        outs = _rollout(dec, stats, state, cond)
        return torch.autograd.grad(sum((o ** 2).sum() for o in outs), params)

    graphed = Graphed(section, device, "the rollout's gradient")
    assert graphed.counts == _captured(per_window)
    before, passes = _launches(), _bptt_counts()
    for _ in range(3):
        graphed()
    torch.cuda.synchronize()
    assert _launches() - before == 3 * per_window
    assert _bptt_counts() == (passes[0] + 3, passes[1] + 3)
