"""The CUDA kernels (decoder rollout, GRU cell, mel spectrogram) against
their plain PyTorch versions, on the card. Imports no jax; run on a machine with a card as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Elsewhere every test skips (inside the fixture, so that every worker
collects the same tests).

Tolerances: one step from the same state 1e-4 (fp32 weights) and 1e-3
(bf16 and int8 weights), because both versions round or quantize the same
inputs the same way and differ only in the order of float32 sums (int8
sums are exact in both); a whole rollout, pose MAE < 1e-3, the budget of
docs/DESIGN.md section 5. The GRU cell: 2e-5, and the mel spectrogram:
2e-4 at n_fft 800, 1024 and 802, the budgets of
tests/test_pallas_kernels.py.
"""

import numpy as np
import pytest
import torch

from zeggs_tpu_torch.models import decoder as D
from zeggs_tpu_torch.models import pose as P
from zeggs_tpu_torch.ops.kernels import decoder_rollout as DR
from zeggs_tpu_torch.config import MelConfig
from zeggs_tpu_torch.ops import mel as M
from zeggs_tpu_torch.ops.kernels import gru_cell as GC
from zeggs_tpu_torch.ops.kernels import mel as MK

pytestmark = pytest.mark.cuda

DT = 1.0 / 60.0
MEL_N_FFTS = [800, 1024, 802]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(device, njoints, hidden, T, seed=0):
    """A decoder of PyTorch-default initialisation and a random B=1
    conditioning, made from a seed."""
    pose_in, pose_out = 6 + njoints * 15 + 3, 6 + njoints * 15
    torch.manual_seed(seed)
    dec = D.Decoder(pose_in, pose_out, 64, 64, hidden).to(device).eval()
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    stats = (t(rng.normal(size=pose_in) * 0.1), t(rng.uniform(0.5, 2.0, pose_in)),
             t(rng.normal(size=pose_out) * 0.1), t(rng.uniform(0.05, 0.5, pose_out)))
    q = rng.normal(size=(1, 4))
    state0 = (t(rng.normal(size=(1, 3))), t(q / np.linalg.norm(q)),
              t(rng.normal(size=(1, 3)) * 0.1), t(rng.normal(size=(1, 3)) * 0.1),
              t(rng.normal(size=(1, njoints, 3))), t(rng.normal(size=(1, njoints, 2, 3))),
              t(rng.normal(size=(1, njoints, 3)) * 0.1), t(rng.normal(size=(1, njoints, 3)) * 0.1))
    cond = (t(rng.normal(size=(1, T, 3)) * 100), t(rng.normal(size=(1, T, 64))),
            t(rng.normal(size=(1, T, 64))))
    return dec, stats, state0, cond


def _kernel_and_plain(dec, stats, state0, cond, dtype):
    packed = DR.pack_decoder(dec.cell, *stats, weights_dtype=dtype)
    pose0 = P.vectorize_input(*state0, cond[0][:, 0], stats[0], stats[1])
    h = D.cell_state_encoder(dec.cell_state_encoder, pose0, cond[2][:, 0])[:, 0].contiguous()
    cond_l0, cond_g0 = DR.conditioning(packed, cond[1], cond[2])
    p0 = torch.cat([x.reshape(-1) for x in state0[2:]])
    root0 = torch.cat([state0[0][0], state0[1][0]])
    args = (packed, cond_l0, cond_g0, cond[0][0, 1:].contiguous(), p0, h, root0, DT)
    before = DR.launches
    rows = DR.rollout_b1(*args)
    torch.cuda.synchronize()
    assert DR.launches == before + 1
    return rows, DR.rollout_b1_plain(*args)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-3),
                                       (torch.int8, 1e-3)])
@pytest.mark.parametrize("njoints,hidden", [(75, 1024), (8, 128)])
@torch.no_grad()
def test_one_step_matches_plain(device, njoints, hidden, dtype, tol):
    dec, stats, state0, cond = _case(device, njoints, hidden, T=2)
    rows, plain = _kernel_and_plain(dec, stats, state0, cond, dtype)
    assert rows.shape == plain.shape == (1, 6 + njoints * 15 + 7)
    assert (rows - plain).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@torch.no_grad()
def test_rollout_matches_plain(device, dtype):
    dec, stats, state0, cond = _case(device, 75, 1024, T=120, seed=1)
    rows, plain = _kernel_and_plain(dec, stats, state0, cond, dtype)
    assert torch.isfinite(rows).all()
    assert (rows - plain).abs().mean().item() < 1e-3


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@torch.no_grad()
def test_pipeline_rollout_counts_one_launch(device, dtype):
    dec, stats, state0, cond = _case(device, 8, 128, T=30, seed=2)
    fn = D.make_fused_b1_fn(dec, *stats, DT, weights_dtype=getattr(torch, dtype))
    before = DR.launches
    out = fn(state0, *cond)
    torch.cuda.synchronize()
    assert DR.launches == before + 1
    assert [tuple(o.shape[:2]) for o in out] == [(1, 30)] * 8


@torch.no_grad()
def test_wrapper_rejects_mixed_devices(device):
    dec, stats, _, _ = _case(device, 8, 128, T=2)
    packed = DR.pack_decoder(dec.cell, *stats, weights_dtype=torch.float32)
    H, PO = packed.hidden, packed.pose_out
    args = [torch.zeros(3, H), torch.zeros(3, 3 * H), torch.zeros(3, 3), torch.zeros(PO),
            torch.zeros(2, H), torch.zeros(7)]
    with pytest.raises(ValueError):
        DR.rollout_b1(packed, *args, DT)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@torch.no_grad()
def test_rollout_plan_on_the_card(device, dtype):
    """One block per SM of the full shared memory; at v1 widths int8 is wholly
    resident and the others partly."""
    dec, stats, _, _ = _case(device, 75, 1024, T=2)
    packed = DR.pack_decoder(dec.cell, *stats, weights_dtype=dtype)
    blocks = DR.grid_blocks(packed)
    assert blocks == torch.cuda.get_device_properties(device).multi_processor_count
    plan = DR.card_plan(packed)
    assert plan.blocks == blocks and plan.table.device.type == "cuda"
    assert (plan.resident_share == 1.0) == (dtype == torch.int8)


@torch.no_grad()
def test_rollout_raises_when_its_plan_cannot_fit(device):
    dec, stats, state0, cond = _case(device, 8, 2048, T=3)
    before = DR.launches
    with pytest.raises(ValueError, match="does not fit"):
        _kernel_and_plain(dec, stats, state0, cond, torch.float32)
    assert DR.launches == before


@pytest.mark.parametrize("barrier", ["grid", "cg"])
def test_barrier_floor_runs(device, barrier):
    sync = DR.barrier_floor(50, barrier)
    torch.cuda.synchronize()
    if barrier == "grid":  # 200 barriers flip the word's top bit back to where it began
        assert sync.tolist() == [0]


@pytest.mark.parametrize("B,in_dim,H", [(64, 1024, 1024), (2, 1024, 1024), (8, 384, 256),
                                        (16, 2304, 512), (11, 1024, 1024), (1, 1024, 1024),
                                        (3, 1024, 1024), (65, 1024, 1024), (33, 200, 64)])
@torch.no_grad()
def test_gru_cell_matches_plain(device, B, in_dim, H):
    torch.manual_seed(B + in_dim + H)
    cell = torch.nn.GRUCell(in_dim, H, device=device)
    rng = np.random.default_rng(B)
    x = torch.as_tensor(rng.normal(size=(B, in_dim)).astype(np.float32), device=device)
    h = torch.as_tensor(rng.normal(size=(B, H)).astype(np.float32), device=device)
    p = GC.pack_gru(cell)
    before = GC.launches
    out = GC.fused_gru_cell(p, x, h)
    torch.cuda.synchronize()
    assert GC.launches == before + 1
    assert out.shape == (B, H) and out.device.type == "cuda"
    assert (out - GC.gru_cell_plain(p, x, h)).abs().max().item() <= 2e-5


@pytest.mark.parametrize("fault", ["dtype", "shape"])
@torch.no_grad()
def test_cuda_tensors_raise_instead_of_falling_back(device, fault):
    cell = torch.nn.GRUCell(64, 64, device=device)
    x, h = torch.zeros(4, 64, device=device), torch.zeros(4, 64, device=device)
    if fault == "dtype":
        x, err = x.half(), TypeError
    else:
        h, err = torch.zeros(4, 32, device=device), ValueError
    before = GC.launches
    with pytest.raises(err):
        GC.fused_gru_cell(GC.pack_gru(cell), x, h)
    dec, stats, _, _ = _case(device, 8, 128, T=2)
    packed = DR.pack_decoder(dec.cell, *stats, weights_dtype=torch.int8)
    H, PO = packed.hidden, packed.pose_out
    args = [torch.zeros(3, H, device=device), torch.zeros(3, 3 * H, device=device),
            torch.zeros(3, 3, device=device), torch.zeros(PO, device=device),
            torch.zeros(2, H, device=device), torch.zeros(7, device=device)]
    if fault == "dtype":
        args[0] = args[0].double()
    else:
        args[1] = torch.zeros(3, 2 * H, device=device)
    with pytest.raises(err):
        DR.rollout_b1(packed, *args, DT)
    assert GC.launches == before


def _speech_like(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = np.sin(2 * np.pi * 180 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (0.3 * x + 0.02 * rng.normal(size=t.shape)).astype(np.float32)


def _mel_cfg(n_fft):
    """The v1 config at another n_fft (hop n_fft // 4): 1024 runs radix-4
    stages only, 802 = 2 x 401 a generic 401-point stage."""
    return MelConfig(filter_length=n_fft, hop_length=n_fft // 4)


@pytest.mark.parametrize("n_fft", MEL_N_FFTS)
@pytest.mark.parametrize("seconds", [4.0, 10.0, 12.0, 0.03])
@torch.no_grad()
def test_mel_spectrogram_matches_plain(device, seconds, n_fft):
    cfg = _mel_cfg(n_fft)
    x = torch.as_tensor(_speech_like(seconds, seed=int(seconds * 10)), device=device)
    before = MK.launches
    out = M.mel_spectrogram_tts(x, cfg)
    torch.cuda.synchronize()
    assert MK.launches == before + 1
    ref = M.mel_spectrogram_tts(x, cfg, fused=False)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 2e-4


@pytest.mark.parametrize("n_fft", MEL_N_FFTS)
@pytest.mark.parametrize("nf", [1, 2, 3, 8, 32, 33, 128, 512])
@pytest.mark.parametrize("zeros", [False, True])
@torch.no_grad()
def test_mel_streaming_windows_match_plain(device, nf, zeros, n_fft):
    cfg = _mel_cfg(n_fft)
    n = (nf - 1) * cfg.hop_length + cfg.filter_length
    x = torch.zeros(n, device=device) if zeros else torch.as_tensor(
        _speech_like(n / 16000, seed=nf)[:n], device=device)
    out = MK.mel_frames(x, nf, cfg)
    ref = MK.mel_frames_plain(x, nf, MK.mel_consts(cfg, x.device))
    torch.cuda.synchronize()
    assert out.shape == (nf, 80) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 2e-4


@torch.no_grad()
def test_mel_cuda_tensors_raise_instead_of_falling_back(device):
    before = MK.launches
    with pytest.raises(TypeError):
        MK.mel_frames(torch.zeros(1000, device=device, dtype=torch.float64), 2, MelConfig())
    with pytest.raises(ValueError):
        MK.mel_frames(torch.zeros(999, device=device), 2, MelConfig())
    assert MK.launches == before


@torch.no_grad()
def test_mel_launch_fits_shared_memory_or_raises(device):
    """n_fft 5000 fits one frame pair a block, not the two `launch_shape`
    asks for at 600 frames; n_fft 16000 fits none and raises."""
    cfg = _mel_cfg(5000)
    nf = 600
    assert MK.launch_shape(nf, torch.cuda.get_device_properties(device).multi_processor_count)[0] == 2
    n = (nf - 1) * cfg.hop_length + cfg.filter_length
    x = torch.as_tensor(_speech_like(n / 16000, seed=5)[:n], device=device)
    out = MK.mel_frames(x, nf, cfg)
    ref = MK.mel_frames_plain(x, nf, MK.mel_consts(cfg, x.device))
    torch.cuda.synchronize()
    assert out.shape == (nf, 80) and (out - ref).abs().max().item() <= 2e-4
    before = MK.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        MK.mel_frames(torch.zeros(16000, device=device), 1, _mel_cfg(16000))
    assert MK.launches == before
