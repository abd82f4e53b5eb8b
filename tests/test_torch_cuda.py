"""The CUDA kernels (decoder rollout, GRU cell, mel spectrogram) against
their plain PyTorch versions, and a training step's gradients against the
CPU's, on the card. Imports no jax; run on a machine with a card as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Elsewhere every test skips (inside the fixture, so that every worker
collects the same tests).

Tolerances: one step from the same state 1e-4 (fp32 weights) and 1e-3
(bf16 and int8 weights), because both versions round or quantize the same
inputs the same way and differ only in the order of float32 sums (int8
sums are exact in both); a whole rollout, pose MAE < 1e-3, the budget of
docs/DESIGN.md section 5. The GRU cell: 2e-5, and the mel spectrogram:
2e-4 at n_fft 800, 1024 and 802 and, through the global-workspace variant,
6000 and 8192: the budgets of tests/test_pallas_kernels.py. Training
gradients: per leaf 1e-4 * max(1, max|g|) against the same step on the CPU,
TF32 off. The GRU cell launched from four threads at once counts every
launch; `generate_batch` over a mesh (two replicas on one card, and every
card where there are several) stays within the pose MAE budget of the
unsharded run. The rollout programs (CUDA graphs of the decoder step)
equal the eager chunk within 1e-6, count their replays' launches, raise
where the step cannot be captured, and give the single-thread result when
two threads replay at once. The train program (CUDA graphs of the train
step) equals the plain step over three steps under every training option
(bit for bit with cuDNN's deterministic algorithms, within rtol 2e-5 /
atol 1e-6 with its default ones), draws fresh noise at each replay from
the registered generator, resumes losslessly and raises where the step
cannot be captured; sample synthesis after a train step replays the new
weights. Generation from the reference's `.pt` pickles writes the same BVH
text as from the `.npz` files; Griffin-Lim on the card against the CPU from
the same first signal: relative L2 error 1e-4 (tests/test_torch_misc.py's
bound); one NCCL process comes up on the card. The profilers capture every
section as a CUDA graph of kernels and raise where a section cannot be
captured; the B=1 profile launches all three of its paths' kernels, its
scan equal to the eager rollout within 1e-6; the roofline counts the v1
decoder cell's 18,910,208 product weights.
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
    asks for at 600 frames; n_fft 16000 fits none and runs the
    global-workspace variant; a workspace too small raises."""
    cfg = _mel_cfg(5000)
    nf = 600
    assert MK.launch_shape(nf, torch.cuda.get_device_properties(device).multi_processor_count)[0] == 2
    n = (nf - 1) * cfg.hop_length + cfg.filter_length
    x = torch.as_tensor(_speech_like(n / 16000, seed=5)[:n], device=device)
    out = MK.mel_frames(x, nf, cfg)
    ref = MK.mel_frames_plain(x, nf, MK.mel_consts(cfg, x.device))
    torch.cuda.synchronize()
    assert out.shape == (nf, 80) and (out - ref).abs().max().item() <= 2e-4
    cfg = _mel_cfg(16000)
    x = torch.as_tensor(_speech_like(2.0, seed=6), device=device)
    out = MK.mel_frames(x, 5, cfg)
    ref = MK.mel_frames_plain(x, 5, MK.mel_consts(cfg, x.device))
    assert (out - ref).abs().max().item() <= 2e-4
    c = MK.mel_consts(cfg, x.device)
    before = MK.launches
    err = MK._library().zeggs_mel_spectrogram(
        x.data_ptr(), 5, c.window.data_ptr(), c.stages.data_ptr(), c.twiddles.data_ptr(),
        c.twiddles.shape[0], c.filters.data_ptr(), c.filters.shape[1], c.support.data_ptr(),
        out.data_ptr(), c.n_fft, c.hop, c.n_mels, c.amp_scale, c.min_amp, c.dyn_range, 1,
        len(c.plan.radices), 1, 0, x.data_ptr(), 64, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="invalid argument"):
        MK._raise_for(err)
    assert MK.launches == before


@pytest.mark.parametrize("n_fft", [6000, 8192])
@pytest.mark.parametrize("nf", [1, 2, 7, 64])
@torch.no_grad()
def test_mel_large_n_fft_variant_matches_plain(device, n_fft, nf):
    """A frame pair of these does not fit a block: the buffers go to a
    global workspace, with the same plan and stages."""
    cfg = _mel_cfg(n_fft)
    c = MK.mel_consts(cfg, device)
    assert MK._workspace_bytes(device.index or 0, nf, c.twiddles.shape[0], c.filters.shape[1],
                               n_fft, c.n_mels, False) > 0
    n = (nf - 1) * cfg.hop_length + n_fft
    x = torch.as_tensor(_speech_like(n / 16000 + 0.01, seed=nf)[:n], device=device)
    before = MK.launches
    out = MK.mel_frames(x, nf, cfg)
    torch.cuda.synchronize()
    assert MK.launches == before + 1
    ref = MK.mel_frames_plain(x, nf, c)
    assert out.shape == (nf, 80) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 2e-4


@pytest.mark.parametrize("n_fft", [800, 802])
@torch.no_grad()
def test_mel_global_variant_forced_matches_plain(device, n_fft):
    cfg = _mel_cfg(n_fft)
    n = 299 * cfg.hop_length + n_fft
    x = torch.as_tensor(_speech_like(n / 16000 + 0.01, seed=3)[:n], device=device)
    c = MK.mel_consts(cfg, device)
    out = MK._launch(x, 300, c, 1, force_global=True)
    assert (out - MK.mel_frames_plain(x, 300, c)).abs().max().item() <= 2e-4


def test_gru_cell_raises_under_autograd_on_the_card(device):
    cell = torch.nn.GRUCell(64, 64, device=device)
    x, h = torch.zeros(4, 64, device=device), torch.zeros(4, 64, device=device)
    before = GC.launches
    with pytest.raises(RuntimeError, match="inference only"):
        GC.pack_gru(cell)
    with torch.no_grad():
        packed = GC.pack_gru(cell)
    with pytest.raises(RuntimeError, match="inference only"):
        GC.fused_gru_cell(packed, x.requires_grad_(), h)
    assert GC.launches == before


def test_gru_cell_counts_launches_from_four_threads(device):
    """Four threads launch the GRU cell on one card at once, each on a
    stream of its own (as the shards of a mesh do): `launches` rises by the
    sum, and every output matches the plain version (2e-5)."""
    import threading

    torch.manual_seed(4)
    cell = torch.nn.GRUCell(1024, 1024, device=device)
    with torch.no_grad():
        p = GC.pack_gru(cell)
        x, h = torch.randn(32, 1024, device=device), torch.randn(32, 1024, device=device)
        ref = GC.gru_cell_plain(p, x, h)
    torch.cuda.synchronize()
    errors, n = [], 200

    def launch():
        stream = torch.cuda.Stream(device)
        with torch.no_grad(), torch.cuda.stream(stream):
            outs = [GC.fused_gru_cell(p, x, h) for _ in range(n)]
            stream.synchronize()
            errors.append(max((o - ref).abs().max().item() for o in outs))

    before = GC.launches
    threads = [threading.Thread(target=launch) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert GC.launches == before + 4 * n
    assert len(errors) == 4 and max(errors) <= 2e-5



def _program_case(device, B=4, T=41, njoints=16, hidden=256, seed=21):
    """A decoder of PyTorch-default initialisation on the card, its pose
    statistics and the carry and (B, T - 1) conditioning of a chunk."""
    dec, stats, state0, (gaze, speech, style) = _rollout_case(device, B, T, njoints, hidden, seed)
    with torch.inference_mode():
        carry = D.init_carry(dec, *state0, gaze[:, 0], style[:, 0],
                             *list(stats.values())[:2])
    return dec, stats, carry, (gaze[:, 1:], speech[:, 1:], style[:, 1:])


def _rollout_case(device, B=4, T=41, njoints=16, hidden=256, seed=21):
    """The decoder and statistics of `_program_case`, the frame-0 state and
    the (B, T) conditioning of a rollout."""
    from zeggs_tpu_torch.infer.programs import _STATS

    pose_in, pose_out = 6 + njoints * 15 + 3, 6 + njoints * 15
    torch.manual_seed(seed)
    dec = D.Decoder(pose_in, pose_out, 64, 64, hidden).to(device).eval().requires_grad_(False)
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32), device=device)

    stats = (t(pose_in, scale=0.1), t(pose_in).abs() + 0.5, t(pose_out, scale=0.1),
             t(pose_out).abs() * 0.2 + 0.05)
    q = t(B, 4)
    state0 = (t(B, 3), q / q.norm(dim=-1, keepdim=True), t(B, 3, scale=0.1), t(B, 3, scale=0.1),
              t(B, njoints, 3), t(B, njoints, 2, 3), t(B, njoints, 3, scale=0.1),
              t(B, njoints, 3, scale=0.1))
    gaze, speech, style = t(B, T, 3, scale=100.0), t(B, T, 64), t(B, T, 64)
    return dec, dict(zip(_STATS, stats)), state0, (gaze, speech, style)


def _eager_chunk(dec, stats, carry, cond, quantize_int8=False):
    return D.rollout_chunk(dec, carry, *cond, *stats.values(), DT, output_indices=(0, 1, 4, 5),
                           quantize_int8=quantize_int8)


def _max_diff(a, b):
    return max((x - y).abs().max().item() for x, y in zip(a, b))


@pytest.mark.parametrize("quantize_int8", [False, True])
def test_graphed_chunk_equals_the_eager_chunk(device, quantize_int8):
    """40 steps of 4 rows through the program cache (two replays of the
    16-step graph, two of the 4-step one) against the eager chunk on the
    card: trajectories and carry within 1e-6 (bitwise expected: the same
    kernels on the same inputs)."""
    from zeggs_tpu_torch.infer.programs import ProgramCache

    dec, stats, carry, cond = _program_case(device)
    with torch.inference_mode():
        ref_carry, ref = _eager_chunk(dec, stats, carry, cond, quantize_int8)
        got_carry, got = ProgramCache(dec, stats, DT).rollout_chunk(carry, *cond,
                                                                    quantize_int8=quantize_int8)
        torch.cuda.synchronize()
    err = max(_max_diff(got, ref), _max_diff(got_carry, ref_carry))
    print(f"graphed against eager chunk (int8 {quantize_int8}): max|diff| {err:.3e}")
    assert err <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_graphed_output_stage_equals_the_eager_one(device, dtype):
    """A rollout of 4 rows and 41 frames with the output stage in its
    finish program (quaternions, the transfer dtype) against `output_stage`
    of the eager `decoder.rollout`: within 1e-6 (bitwise expected)."""
    from zeggs_tpu_torch.infer.programs import ProgramCache, output_stage

    dec, stats, state0, cond = _rollout_case(device)
    dtype = getattr(torch, dtype)
    with torch.inference_mode():
        want = output_stage(D.rollout(dec, *state0, *cond, *stats.values(), DT,
                                      output_indices=(0, 1, 4, 5)), dtype)
        got = ProgramCache(dec, stats, DT).rollout(state0, *cond, output_dtype=dtype)
        torch.cuda.synchronize()
    assert [g.dtype for g in got] == [dtype] * 4
    assert [g.shape for g in got] == [w.shape for w in want]
    assert _max_diff([g.float() for g in got], [w.float() for w in want]) <= 1e-6


def test_finish_outputs_outlive_the_next_replay(device):
    """Two rollouts of one shape at float16 transfer, back to back and not
    synchronised: one finish program serves both, and the first's outputs
    (copied out of the graph's buffers) still equal its eager output stage
    after the second has replayed the graph."""
    from zeggs_tpu_torch.infer.programs import ProgramCache, output_stage

    dec, stats, state0, cond = _rollout_case(device)
    other = _rollout_case(device, seed=22)[3]
    cache = ProgramCache(dec, stats, DT)
    with torch.inference_mode():
        first = cache.rollout(state0, *cond, output_dtype=torch.float16)
        second = cache.rollout(state0, *other, output_dtype=torch.float16)
        want = [output_stage(D.rollout(dec, *state0, *c, *stats.values(), DT,
                                       output_indices=(0, 1, 4, 5)), torch.float16)
                for c in (cond, other)]
        torch.cuda.synchronize()
    assert len(cache.finishes()) == 1
    for got, ref in zip((first, second), want):
        assert _max_diff([g.float() for g in got], [w.float() for w in ref]) <= 1e-6
    assert _max_diff([g.float() for g in first], [g.float() for g in second]) > 0.0


def test_launch_counter_counts_replays(device):
    """A capture adds nothing and its one eager warm-up step adds one
    GRU-cell launch; each replay adds the launches its graph captured. 40
    steps: the 16- and 4-step programs, 40 + 2 launches at the first call,
    40 at the next."""
    from zeggs_tpu_torch.infer.programs import ProgramCache

    dec, stats, carry, cond = _program_case(device)
    cache = ProgramCache(dec, stats, DT)
    counts = []
    with torch.inference_mode():
        for _ in range(2):
            before = GC.launches
            cache.rollout_chunk(carry, *cond)
            counts.append(GC.launches - before)
    assert counts == [42, 40]
    assert sorted(p.launches for _, p in cache.programs()) == [4, 16]


def test_an_uncapturable_step_raises(device, monkeypatch):
    """A host sync inside the step (injected into the pose integration)
    makes the capture fail: the rollout raises instead of returning the
    eager result, and the card keeps working afterwards."""
    from zeggs_tpu_torch.infer.programs import ProgramCache

    dec, stats, carry, cond = _program_case(device)
    integrate = P.devectorize_output

    def syncing(*args, **kw):
        out = integrate(*args, **kw)
        out[0].sum().item()  # waits for the card: not allowed while capturing
        return out

    monkeypatch.setattr(P, "devectorize_output", syncing)
    with torch.inference_mode(), pytest.raises(RuntimeError, match="capturing the rollout"):
        ProgramCache(dec, stats, DT).rollout_chunk(carry, *cond)
    monkeypatch.undo()
    with torch.inference_mode():
        ref = _eager_chunk(dec, stats, carry, cond)[1]
        got = ProgramCache(dec, stats, DT).rollout_chunk(carry, *cond)[1]
    assert _max_diff(got, ref) <= 1e-6


@pytest.mark.parametrize("slots", [(0, 1), ("shared", "shared")])
def test_block_slots_replaying_at_once_give_the_single_thread_result(device, slots):
    """Two threads on one card, each on a stream of its own, roll out their
    own rows five times over: through two slots (one captures its programs
    while the other replays) or through one slot's programs (serialised by
    the program's lock and event). Every result equals the single-thread
    run of the same rows."""
    import threading

    from zeggs_tpu_torch.infer.programs import ProgramCache

    dec, stats, carry_a, cond_a = _program_case(device, seed=21)
    _, _, carry_b, cond_b = _program_case(device, seed=22)
    with torch.inference_mode():
        refs = [ProgramCache(dec, stats, DT).rollout_chunk(c, *k)[1]
                for c, k in ((carry_a, cond_a), (carry_b, cond_b))]
        cache = ProgramCache(dec, stats, DT)
        cache.rollout_chunk(carry_a, *cond_a, slot=slots[0])  # slot 0's programs exist
    torch.cuda.synchronize()
    errors = [None, None]

    def run(i, carry, cond):
        stream = torch.cuda.Stream(device)
        with torch.inference_mode(), torch.cuda.stream(stream):
            outs = [cache.rollout_chunk(carry, *cond, slot=slots[i])[1] for _ in range(5)]
            stream.synchronize()
        errors[i] = max(_max_diff(o, refs[i]) for o in outs)

    threads = [threading.Thread(target=run, args=(0, carry_a, cond_a)),
               threading.Thread(target=run, args=(1, carry_b, cond_b))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert errors == [0.0, 0.0]

def _train_case(rnn_cond="normal", compute_dtype="float32", remat=False):
    """Small-width options, statistics and a random batch (B=3, 24 frames,
    8 joints) of a training step."""
    from zeggs_tpu_torch.config import Options

    rng = np.random.default_rng(7)
    J, B, T, L = 8, 3, 24, 40
    parents = [-1, 0, 1, 2, 3, 4, 3, 3]
    pose_in, pose_out = 6 + 15 * J + 3, 6 + 15 * J
    opts = Options.from_options_dict({"net_opt": {
        "decoder": {"nhidden": 64, "rnn_cond": rnn_cond},
        "speech_encoder": {"nhidden": 16, "speech_encoding_size": 16},
        "style_encoder": {"nhidden": 24, "style_encoding_size": 8}},
        "train_opt": {"compute_dtype": compute_dtype, "remat": remat}})
    stats = dict(audio_input_mean=rng.normal(size=81) * 0.1, audio_input_std=np.float32(1.5),
                 anim_input_mean=rng.normal(size=pose_in) * 0.1,
                 anim_input_std=rng.uniform(0.5, 2.0, pose_in),
                 anim_output_mean=rng.normal(size=pose_out) * 0.1,
                 anim_output_std=rng.uniform(0.05, 0.5, pose_out))
    q = rng.normal(size=(B, T, 4))
    batch = dict(root_pos=rng.normal(size=(B, T, 3)) * 10,
                 root_rot=q / np.linalg.norm(q, axis=-1, keepdims=True),
                 root_vel=rng.normal(size=(B, T, 3)), root_vrt=rng.normal(size=(B, T, 3)),
                 lpos=rng.normal(size=(B, T, J, 3)), ltxy=rng.normal(size=(B, T, J, 2, 3)),
                 lvel=rng.normal(size=(B, T, J, 3)), lvrt=rng.normal(size=(B, T, J, 3)),
                 audio_features=rng.normal(size=(B, T, 81)),
                 gaze_pos=np.repeat(rng.normal(size=(B, 1, 3)) * 100, T, axis=1),
                 example=rng.normal(size=(B, L, pose_in)))
    dims = dict(num_audio_features=81, pose_input_size=pose_in, pose_output_size=pose_out)
    return opts, stats, parents, batch, dims, [L, 33, 20]


def _step(opts, stats, parents, batch, dims, lengths, dev, generator=None, frames=None):
    """(loss, {parameter: gradient on the CPU}) of one step from seed 5's
    networks on ``dev``; deterministic without a generator."""
    from zeggs_tpu_torch.train import loop

    nets = loop.init_networks(opts, dims, 3, 5, dev)
    b = {k: torch.as_tensor(np.asarray(v, np.float32)[:, :frames] if k != "example"
                            else np.asarray(v, np.float32), device=dev)
         for k, v in batch.items()}
    b["example_lengths"] = torch.tensor(lengths, device=dev)
    loss, _ = loop.make_loss_fn(opts, stats, parents, DT, deterministic=generator is None)(
        nets, b, 7500, generator)
    loss.backward()
    return loss.item(), {k: p.grad.cpu() for k, p in loop.named_parameters(nets).items()}


@pytest.mark.parametrize("rnn_cond", ["normal", "film"])
def test_train_step_gradients_match_the_cpu(device, rnn_cond):
    """One deterministic small-width step on the card against the CPU, and
    no kernel launch inside it."""
    case = _train_case(rnn_cond)
    grads = {}
    for dev in ("cpu", device):
        counts = (GC.launches, MK.launches, DR.launches)
        grads[str(dev)] = _step(*case, dev)[1]
        assert (GC.launches, MK.launches, DR.launches) == counts
    for k, g in grads["cpu"].items():
        assert (grads["cuda"][k] - g).abs().max().item() <= 1e-4 * max(1.0, g.abs().max().item()), k


def test_remat_step_equals_the_step_without_it_on_the_card(device):
    """With dropout and VAE noise from one seeded generator: the same loss
    and gradients (rtol 1e-5, atol 1e-6), and the generator's state after
    the backward pass equal (the rematerialised steps draw nothing)."""
    results = []
    for remat in (False, True):
        generator = torch.Generator(device=device).manual_seed(11)
        loss, grads = _step(*_train_case(remat=remat), device, generator=generator)
        results.append((loss, grads, generator.get_state()))
    (loss, grads, state), (loss_r, grads_r, state_r) = results
    assert torch.equal(state, state_r)
    assert loss_r == pytest.approx(loss, rel=1e-6)
    for k, g in grads.items():
        torch.testing.assert_close(grads_r[k], g, rtol=1e-5, atol=1e-6, msg=k)


def test_bfloat16_step_on_the_card_matches_the_cpu(device):
    """bfloat16 products over one decoder step (2 frames), the card against
    the CPU at the bound tests/test_torch_train_grads.py holds the port's
    bfloat16 step to against JAX's: loss rtol 1e-4, every gradient 4e-2 of
    max(1, max|g|); and the products ran in bfloat16 (the loss differs from
    float32's)."""
    case = _train_case(compute_dtype="bfloat16")
    loss, grads = _step(*case, device, frames=2)
    loss_cpu, grads_cpu = _step(*case, "cpu", frames=2)
    loss_f32, _ = _step(*_train_case(), device, frames=2)
    assert loss == pytest.approx(loss_cpu, rel=1e-4) and loss != loss_f32
    for k, g in grads_cpu.items():
        assert (grads[k] - g).abs().max().item() <= 4e-2 * max(1.0, g.abs().max().item()), k


@pytest.fixture(scope="module")
def small_models(device, tmp_path_factory):
    """A small model (8 joints, decoder H=128) as .npz and as the
    reference's .pt pickles, a label-style model of the same widths, their
    data directory, a style BVH and a WAV."""
    import json
    import shutil
    from pathlib import Path

    from zeggs_tpu_torch.config import Options
    from zeggs_tpu_torch.io import bvh, checkpoint, torch_compat, wav, weights
    from zeggs_tpu_torch.models.speech_encoder import SpeechEncoder
    from zeggs_tpu_torch.models.style_encoder import StyleEncoder

    root = tmp_path_factory.mktemp("small_models")
    names = ["Hips", "Spine", "Spine1", "Spine2", "Neck", "Head", "Arm", "Hand"]
    J, parents = len(names), [-1, 0, 1, 2, 3, 4, 3, 6]
    pose_in, pose_out = 6 + 15 * J + 3, 6 + 15 * J
    rng = np.random.default_rng(11)
    data = root / "processed"
    data.mkdir()
    (data / "data_definition.json").write_text(json.dumps(
        {"dt": DT, "label_names": ["A", "B"], "parents": parents, "bone_names": names}))
    repo = Path(__file__).resolve().parents[1]
    shutil.copy(repo / "configs" / "data_pipeline_conf_v1.json", data / "data_pipeline_conf.json")
    np.savez(data / "stats.npz", audio_input_mean=rng.normal(size=81).astype(np.float32),
             audio_input_std=np.float32(1.5),
             anim_input_mean=(rng.normal(size=pose_in) * 0.1).astype(np.float32),
             anim_input_std=rng.uniform(0.5, 2.0, pose_in).astype(np.float32),
             anim_output_mean=(rng.normal(size=pose_out) * 0.1).astype(np.float32),
             anim_output_std=rng.uniform(0.05, 0.5, pose_out).astype(np.float32))
    torch.manual_seed(11)
    trees = {n: weights.to_jax(m) for n, m in (
        ("speech_encoder", SpeechEncoder(81, 16, 16)),
        ("style_encoder", StyleEncoder(pose_in, 24, 8)),
        ("decoder", D.Decoder(pose_in, pose_out, 16, 8, 128)))}
    for n, tree in trees.items():
        checkpoint.save(root / "npz" / f"{n}.npz", tree)
    torch_compat.save_reference_networks(root / "pt", trees)
    # a label-style model: the speech encoder and a decoder styled by the
    # one-hot of the two labels
    checkpoint.save(root / "label" / "speech_encoder.npz", trees["speech_encoder"])
    checkpoint.save(root / "label" / "decoder.npz",
                    weights.to_jax(D.Decoder(pose_in, pose_out, 16, 2, 128)))
    T = 120
    t = np.linspace(0, 2 * np.pi, T)[:, None, None]
    offsets = rng.uniform(-10, 10, (J, 3)).astype(np.float32)
    bvh.save(root / "style.bvh", {
        "rotations": (20 * np.sin(t + rng.uniform(0, 6, (1, J, 3)))).astype(np.float32),
        "positions": np.repeat(offsets[None], T, axis=0), "offsets": offsets,
        "parents": np.asarray(parents, np.int32), "names": names,
        "order": "zyx", "frametime": DT})
    wav.write_wavefile(root / "audio.wav", _speech_like(2.0, 3), 16000)
    opts = Options.from_options_dict({"net_opt": {"style_encoder": {"nhidden": 24,
                                                                    "style_encoding_size": 8}}})
    return dict(root=root, data=data, opts=opts)


def test_generation_from_reference_checkpoints_on_the_card(small_models, tmp_path):
    from zeggs_tpu_torch.infer import GesturePipeline, generate_gesture

    m, texts = small_models, {}
    for tag in ("npz", "pt"):
        pipe = GesturePipeline(m["root"] / tag, m["data"], options=m["opts"], device="cuda")
        before = (DR.launches, MK.launches)
        generate_gesture(m["root"] / "audio.wav", [(m["root"] / "style.bvh", None)], None, None,
                         tmp_path, file_name=tag, seed=3, pipeline=pipe)
        torch.cuda.synchronize()
        assert (DR.launches, MK.launches) == (before[0] + 1, before[1] + 1)
        texts[tag] = (tmp_path / f"{tag}.bvh").read_text()
    assert texts["pt"] == texts["npz"]


def test_label_request_launches_the_decoder_once(small_models, tmp_path):
    """A label-style B=1 request with a first pose: one decoder launch (fp32
    weights) and one mel launch on the card, and the CPU's BVH within the
    pose MAE budget of 1e-3."""
    from zeggs_tpu_torch.infer import GesturePipeline, generate_gesture
    from zeggs_tpu_torch.io import bvh

    m, launched = small_models, {}
    for tag in ("cpu", "cuda"):
        pipe = GesturePipeline(m["root"] / "label", m["data"], options=m["opts"],
                               style_encoding_type="label", device=tag,
                               rollout_weights="float32")
        before = (DR.launches, GC.launches, MK.launches)
        generate_gesture(m["root"] / "audio.wav", ["B"], None, None, tmp_path,
                         style_encoding_type="label", first_pose=m["root"] / "style.bvh",
                         file_name=tag, pipeline=pipe)
        torch.cuda.synchronize()
        launched[tag] = tuple(n - b for n, b in zip((DR.launches, GC.launches, MK.launches),
                                                    before))
    assert launched == {"cpu": (0, 0, 0), "cuda": (1, 0, 1)}
    a, b = bvh.load(tmp_path / "cpu.bvh"), bvh.load(tmp_path / "cuda.bvh")
    assert a["rotations"].shape == b["rotations"].shape and np.isfinite(b["rotations"]).all()
    assert np.abs(a["positions"] - b["positions"]).mean() < 1e-3
    assert np.abs(a["rotations"] - b["rotations"]).mean() < 1e-3


def test_generate_batch_over_a_mesh_on_the_card(small_models, tmp_path):
    """Three requests as one chunk over two replicas on cuda:0 and, with
    several cards, over every card, at fp32 rollout weights: each BVH within
    the pose MAE budget of 1e-3 of the run without a mesh; with the mesh's
    programs captured first by `warmup`, GRU-cell launches = decoder steps
    x blocks (the chunk padded to a multiple of the mesh), no decoder
    launch, one mel launch a request."""
    from zeggs_tpu_torch.infer import GesturePipeline
    from zeggs_tpu_torch.infer.batch import Request, generate_batch, warmup
    from zeggs_tpu_torch.io import bvh
    from zeggs_tpu_torch.parallel import create_mesh

    m = small_models
    pipe = GesturePipeline(m["root"] / "npz", m["data"], options=m["opts"], device="cuda",
                           rollout_weights="float32")
    reqs = [Request(audio=m["root"] / "audio.wav", styles=[(m["root"] / "style.bvh", None)],
                    file_name=f"r{i}", seed=i) for i in range(3)]
    generate_batch(pipe, reqs, tmp_path / "plain", bucket=64)
    n = bvh.load(tmp_path / "plain" / "r0.bvh")["rotations"].shape[0]
    steps = -(-n // 64) * 64 - 1
    meshes = [create_mesh(devices=["cuda:0"] * 2)]
    if torch.cuda.device_count() > 1:
        meshes.append(create_mesh())
    for k, mesh in enumerate(meshes):
        warmup(pipe, [n] * len(reqs), bucket=64, mesh=mesh)
        before = (DR.launches, GC.launches, MK.launches)
        generate_batch(pipe, reqs, tmp_path / f"mesh{k}", bucket=64, mesh=mesh)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip((DR.launches, GC.launches, MK.launches), before))
        assert launched == (0, steps * mesh.size, 3), (mesh, launched)
        for r in reqs:
            a = bvh.load(tmp_path / "plain" / f"{r.file_name}.bvh")
            b = bvh.load(tmp_path / f"mesh{k}" / f"{r.file_name}.bvh")
            assert np.isfinite(b["rotations"]).all()
            assert np.abs(a["positions"] - b["positions"]).mean() < 1e-3
            assert np.abs(a["rotations"] - b["rotations"]).mean() < 1e-3


def test_pipelined_chunks_on_the_card(small_models, tmp_path, monkeypatch):
    """Seven requests in chunks of two (four chunks, copies to pinned
    memory, collected two dispatches late): at depth 2 the BVHs of depth 0,
    text for text, in request order; over a mesh of two replicas on cuda:0
    within the pose MAE budget of 1e-3; at float16 transfer within
    tests/test_batch_infer.py's float16 bounds."""
    from zeggs_tpu_torch.infer import GesturePipeline
    from zeggs_tpu_torch.infer import batch as B
    from zeggs_tpu_torch.infer.batch import Request, generate_batch
    from zeggs_tpu_torch.io import bvh
    from zeggs_tpu_torch.parallel import create_mesh

    m = small_models
    reqs = [Request(audio=m["root"] / "audio.wav", styles=[(m["root"] / "style.bvh", None)],
                    file_name=f"r{i}", seed=i) for i in range(7)]
    names = [f"r{i}.bvh" for i in range(7)]
    runs = {"depth2": ("float32", 2, None), "depth0": ("float32", 0, None),
            "mesh": ("float32", 2, create_mesh(devices=["cuda:0"] * 2)),
            "float16": ("float16", 2, None)}
    for tag, (dtype, depth, mesh) in runs.items():
        monkeypatch.setattr(B, "PIPELINE_DEPTH", depth)
        pipe = GesturePipeline(m["root"] / "npz", m["data"], options=m["opts"], device="cuda",
                               rollout_weights="float32", transfer_dtype=dtype)
        written = generate_batch(pipe, reqs, tmp_path / tag, bucket=64, max_batch=2, mesh=mesh)
        assert [p.name for p in written] == names, tag
    for name in names:
        a = bvh.load(tmp_path / "depth2" / name)
        assert (tmp_path / "depth2" / name).read_text() == (tmp_path / "depth0" / name).read_text()
        b = bvh.load(tmp_path / "mesh" / name)
        assert np.abs(a["positions"] - b["positions"]).mean() < 1e-3
        assert np.abs(a["rotations"] - b["rotations"]).mean() < 1e-3
        h = bvh.load(tmp_path / "float16" / name)
        dr = np.abs((a["rotations"] - h["rotations"] + 180.0) % 360.0 - 180.0)
        assert dr.max() < 3.0 and np.median(dr) < 0.05
        assert np.abs(a["positions"] - h["positions"]).max() <= 0.5


def test_mesh_chunk_inputs_outlive_their_blocks(small_models, tmp_path, monkeypatch):
    """Seven requests in chunks of two over a mesh of two replicas on
    cuda:0. After each chunk's blocks have returned (their streams may still
    read the chunk's inputs), the caller's stream takes fresh memory of the
    inputs' sizes and fills it with NaN, as the next chunk's assembly would:
    the BVHs equal those of an undisturbed run, text for text, since a
    chunk's inputs are held until the chunk is collected."""
    from concurrent.futures import wait

    from zeggs_tpu_torch.infer import GesturePipeline
    from zeggs_tpu_torch.infer import batch as B
    from zeggs_tpu_torch.infer.batch import Request, generate_batch
    from zeggs_tpu_torch.parallel import create_mesh

    m = small_models
    reqs = [Request(audio=m["root"] / "audio.wav", styles=[(m["root"] / "style.bvh", None)],
                    file_name=f"r{i}", seed=i) for i in range(7)]
    pipe = GesturePipeline(m["root"] / "npz", m["data"], options=m["opts"], device="cuda",
                           rollout_weights="float32")
    mesh = create_mesh(devices=["cuda:0"] * 2)
    clean = generate_batch(pipe, reqs, tmp_path / "clean", bucket=64, max_batch=2, mesh=mesh)
    run_chunk = B._run_chunk

    def disturbed(*args):
        blocks = run_chunk(*args)
        sizes = [t.numel() for t in (*args[4], *args[5:])]
        del args
        wait(blocks)
        junk = [torch.full((n,), float("nan"), device="cuda") for n in sizes for _ in range(3)]
        del junk
        return blocks

    monkeypatch.setattr(B, "_run_chunk", disturbed)
    written = generate_batch(pipe, reqs, tmp_path / "disturbed", bucket=64, max_batch=2,
                             mesh=mesh)
    assert [p.name for p in written] == [p.name for p in clean]
    for a, b in zip(clean, written):
        assert a.read_text() == b.read_text(), a.name


@pytest.fixture(scope="module")
def small_run(device, tmp_path_factory):
    """A training run's layout at small width: three 4 s clips (8 joints)
    through the port's corpus pipeline (the last one validation) under
    processed/, and networks from a seed (the 64-wide style embedding that
    the evaluation's default options read) at models/0/."""
    import csv
    import json

    from zeggs_tpu_torch import config as C
    from zeggs_tpu_torch.data.dataset import WindowedDataset
    from zeggs_tpu_torch.data.pipeline import data_pipeline
    from zeggs_tpu_torch.io import bvh, checkpoint, wav, weights
    from zeggs_tpu_torch.train import loop

    root = tmp_path_factory.mktemp("small_run")
    orig = root / "original"
    orig.mkdir()
    names = ["Hips", "Spine", "Spine1", "Spine2", "Neck", "Head", "Arm", "Hand"]
    J, parents, T = len(names), [-1, 0, 1, 2, 3, 4, 3, 6], 240
    rng = np.random.default_rng(13)
    rows = []
    for i in range(3):
        name = f"{i:03d}_Clip_{i}"
        t = np.linspace(0, 4 * np.pi, T)[:, None, None]
        offsets = rng.uniform(-10, 10, (J, 3)).astype(np.float32)
        offsets[0] = 0
        positions = np.repeat(offsets[None], T, axis=0)
        positions[:, 0, 1] += 90.0
        bvh.save(orig / f"{name}.bvh", {
            "rotations": (rng.uniform(5, 25, (1, J, 3)) * np.sin(t + rng.uniform(0, 6, (1, J, 3)))
                          ).astype(np.float32),
            "positions": positions, "offsets": offsets, "parents": np.asarray(parents, np.int32),
            "names": names, "order": "zyx", "frametime": DT})
        wav.write_wavefile(orig / f"{name}.wav", _speech_like(4.0, 20 + i), 16000)
        with open(orig / f"{name}.csv", "w", newline="") as f:
            csv.writer(f).writerows([["#", "Start", "End"], ["R1", "0:0.0", "0:4.0"]])
        rows.append(dict(audio_filename=f"{name}.wav", audio_start_time="00:00:00:00",
                         anim_start_time="00:00:00:00", acting_start_time="00:00:00:30",
                         acting_end_time="00:00:03:30", style=["A", "B", "A"][i],
                         anim_bvh=f"{name}.bvh", validation="TRUE" if i == 2 else "FALSE"))
    with open(root / "info.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    data_pipeline(C.PipelineConfig(
        base_path=str(root), processed_data_path="processed", info_filename="info.csv",
        len_ratios=(1.0,), save_trimmed_audio=False, save_trimmed_animation=False), device="cpu")
    processed = root / "processed"
    ds = WindowedDataset(processed / "data_definition.json", processed / "processed_data.npz", 32)
    opts = C.Options.from_options_dict({"net_opt": {
        "decoder": {"nhidden": 64}, "speech_encoder": {"nhidden": 16, "speech_encoding_size": 16},
        "style_encoder": {"nhidden": 24}}})
    nets = loop.init_networks(opts, ds.get_shapes(), ds.nlabels, 3, "cpu")
    checkpoint.save_train_state(root / "models" / "0", 0,
                                {n: weights.to_jax(m) for n, m in nets.items()})
    return dict(root=root, ds=ds)


def test_evaluate_on_the_card_matches_the_cpu(small_run, monkeypatch):
    """`cli.eval_checkpoint.evaluate` on the card against the CPU: its
    rollouts replay the rollout programs, one GRU-cell launch a decoder
    step of the validation rollouts and one a program's capture; the
    tolerances of tests/test_torch_quality.py (`chip_smoke.reports_agree`:
    rtol 1e-3 and a rounding quantum; the jerk and variance ratios within
    the bounds derived from the two rollouts' difference); equal gate
    verdicts."""
    from chip_smoke import eval_bounds, ladder_programs, reports_agree
    from zeggs_tpu_torch.cli import eval_checkpoint as E
    from zeggs_tpu_torch.infer.programs import ProgramCache

    rollouts = {"cuda": [], "cpu": []}
    original = ProgramCache.rollout

    def recording(*args, **kw):
        out = original(*args, **kw)  # root_pos, root_rot, lpos, ltxy
        rollouts[out[1].device.type].append(tuple(out[i][0].cpu().numpy() for i in (0, 2)))
        return out

    monkeypatch.setattr(ProgramCache, "rollout", recording)
    root, ds = small_run["root"], small_run["ds"]
    before = (DR.launches, GC.launches, MK.launches)
    card = E.evaluate(root, 0, device="cuda")
    torch.cuda.synchronize()
    launched = tuple(n - b for n, b in zip((DR.launches, GC.launches, MK.launches), before))
    cpu = E.evaluate(root, 0, device="cpu")
    steps = [len(r[1]) - 1 for r in rollouts["cuda"]]
    # every decoder step replayed, and one eager warm-up step a program
    assert launched == (0, sum(steps) + ladder_programs(steps), 0)
    assert card["n_valid_clips"] == cpu["n_valid_clips"] == len(rollouts["cpu"]) == 1
    assert reports_agree(card, cpu, eval_bounds(ds, rollouts["cuda"], rollouts["cpu"])) == []
    assert E.gate(card) == E.gate(cpu)


# -- the train program (CUDA graphs of the train step) ----------------------

#: (train options, network options, device corpus) of each training option
TRAIN_OPTIONS = {
    "float32": ({}, {}, True),
    "bfloat16": ({"compute_dtype": "bfloat16"}, {}, True),
    "remat": ({"remat": True}, {}, True),
    "gru_style_body": ({}, {"style_encoder": {"type": "gru"}}, True),
    "film": ({}, {"decoder": {"rnn_cond": "film"}}, True),
    "label": ({"style_encoding_type": "label"}, {}, True),
    "host_batches": ({}, {}, False),
}


def _small_trainer(small_run, tmp_path, train_opt=None, net_opt=None, device_corpus=True,
                   device="cuda"):
    """A `Trainer` at small width (decoder H=64, B=4, window 32, examples of
    32-64 frames) over the small run's corpus, from seed 9."""
    from zeggs_tpu_torch.config import Options
    from zeggs_tpu_torch.train.loop import Trainer

    od = {"net_opt": {"decoder": {"nhidden": 64},
                      "speech_encoder": {"nhidden": 16, "speech_encoding_size": 16},
                      "style_encoder": {"nhidden": 24, "style_encoding_size": 8,
                                        "example_length": 32}},
          "train_opt": {"batchsize": 4, "window": 32, "seed": 9, "generate_samples_step": 10_000,
                        "use_tensorboard": False, **(train_opt or {})}}
    for block, values in (net_opt or {}).items():
        od["net_opt"][block].update(values)
    processed = small_run["root"] / "processed"
    return Trainer(Options.from_options_dict(od), tmp_path / "models", tmp_path / "logs",
                   processed / "processed_data.npz", processed / "data_definition.json",
                   device_corpus=device_corpus, device=device)


def _draws(trainer, n, seed=4):
    rng = np.random.default_rng(seed)
    label = trainer.opts.train.style_encoding_type == "label"
    return [(rng.permutation(len(trainer.ds))[: trainer.opts.train.batchsize],
             None if label else trainer.ds.sample_example_length(rng)) for _ in range(n)]


def _device_batch(trainer, inputs):
    """The batch the program gathers (or copies) from ``inputs``, built
    eagerly for the plain step."""
    dev = trainer.device
    if trainer.device_corpus is None:
        return {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
    x = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in inputs.items()}
    if "labels" in x:
        return trainer.device_corpus.gather_batch(x["window_starts"], labels=x["labels"],
                                                  nlabels=trainer.ds.nlabels)
    return trainer.device_corpus.gather_batch(x["window_starts"], x["ex_idx"], x["ex_lengths"])


def _worst(a, b):
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def _graphed_and_eager(small_run, tmp_path, option, eager_option=None):
    """Three steps of the trainer's program (one eager warm-up, a capture,
    then replays) under ``option`` and three steps of the plain
    `make_train_step` under ``eager_option`` (default the same) from the
    same seed, inputs and noise generator -> (pairs of tensors that must
    agree: parameters, RAdam moments, losses; the two generators)."""
    from zeggs_tpu_torch.train.loop import make_train_step

    train_opt, net_opt, device_corpus = TRAIN_OPTIONS[option]
    graphed = _small_trainer(small_run, tmp_path / "g", train_opt, net_opt, device_corpus)
    eager = _small_trainer(small_run, tmp_path / "e", *TRAIN_OPTIONS[eager_option or option])
    optimizer, plain = make_train_step(eager.opts, eager.ds.stats, eager.ds.parents, eager.ds.dt,
                                       eager.nets)
    losses = []
    for i, (idx, ewl) in enumerate(_draws(graphed, 3)):
        inputs = graphed._batch(idx, ewl)
        a = graphed.train_step(inputs)
        b = plain(_device_batch(eager, inputs), i, eager.generator)
        losses.append((a["total_loss"], b["total_loss"]))
    torch.cuda.synchronize()
    assert len(graphed.program.graphs) == 1 and graphed.program.steps == 3
    pairs = [(p, optimizer.params[k]) for k, p in graphed.optimizer.params.items()]
    pairs += [(m, optimizer.exp_avg[k]) for k, m in graphed.optimizer.exp_avg.items()]
    pairs += [(v, optimizer.exp_avg_sq[k]) for k, v in graphed.optimizer.exp_avg_sq.items()]
    return pairs + losses, (graphed.generator, eager.generator)


@pytest.mark.parametrize("option", list(TRAIN_OPTIONS))
def test_graphed_train_steps_equal_eager_steps(small_run, tmp_path, option):
    """The program against the plain step over three steps from one state
    (`_graphed_and_eager`), for each training option. With cuDNN's
    deterministic algorithms they are equal bit for bit. With its default
    algorithms (what a run uses) the backward of the style encoder's
    convolutions may sum in another order from run to run, eager against
    eager too: parameters, RAdam moments and losses within rtol 2e-5 /
    atol 1e-6, the multi-process bound. The generators' states are equal
    either way."""
    for deterministic in (True, False):
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, allow_tf32=False,
                                        deterministic=deterministic):
            pairs, (g, e) = _graphed_and_eager(small_run, tmp_path / str(deterministic), option)
        bitwise = all(torch.equal(x, y) for x, y in pairs)
        print(f"train option {option}, cuDNN deterministic {deterministic}: graphed against "
              f"eager over 3 steps, worst |diff| {_worst(*zip(*pairs)):.3e}, bitwise {bitwise}")
        assert torch.equal(g.get_state(), e.get_state())
        if deterministic:
            assert bitwise
        for x, y in pairs:
            torch.testing.assert_close(x, y, rtol=2e-5, atol=1e-6)


def test_graphed_remat_steps_equal_eager_steps_without_remat(small_run, tmp_path):
    """remat recomputes each decoder step inside the captured backward:
    three graphed remat steps against three eager steps without remat from
    one state, within rtol 2e-5 / atol 1e-6 (deterministic cuDNN; the sums
    of a recomputed step may round differently)."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, allow_tf32=False,
                                    deterministic=True):
        pairs, (g, e) = _graphed_and_eager(small_run, tmp_path, "remat", "float32")
    print(f"graphed remat against eager without remat over 3 steps: worst |diff| "
          f"{_worst(*zip(*pairs)):.3e}")
    assert torch.equal(g.get_state(), e.get_state())
    for x, y in pairs:
        torch.testing.assert_close(x, y, rtol=2e-5, atol=1e-6)


def test_a_graphed_run_resumes_losslessly(small_run, tmp_path):
    """An epoch of graphed steps (B=32), a checkpoint, a new trainer
    resumed from it for a second epoch (its own warm-up and capture):
    parameters, RAdam moments and the noise generator bit for bit those of
    two uninterrupted graphed epochs (cuDNN's deterministic algorithms)."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, allow_tf32=False,
                                    deterministic=True):
        first = _small_trainer(small_run, tmp_path / "a", {"batchsize": 32})
        bpe = len(first.ds) // 32
        first.run(max_iterations=bpe)
        first.save_checkpoint()
        resumed = _small_trainer(small_run, tmp_path / "a", {"batchsize": 32, "resume": True})
        assert resumed.iteration == bpe >= 3
        resumed.run(max_iterations=2 * bpe)
        whole = _small_trainer(small_run, tmp_path / "b", {"batchsize": 32})
        whole.run(max_iterations=2 * bpe)
    assert [len(t.program.graphs) for t in (first, resumed, whole)] == [1, 1, 1]
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())
    for k, p in whole.optimizer.params.items():
        assert torch.equal(resumed.optimizer.params[k], p), k
        assert torch.equal(resumed.optimizer.exp_avg[k], whole.optimizer.exp_avg[k]), k
        assert torch.equal(resumed.optimizer.exp_avg_sq[k], whole.optimizer.exp_avg_sq[k]), k


def test_replays_draw_fresh_noise(small_run, tmp_path):
    """At learning rate 0 and on the same inputs every step, the losses of
    the replays differ only by their dropout and VAE noise: they are
    pairwise different and equal the eager steps' from the same generator,
    the generator's offset moves on as the eager one's, and the default
    generator is never drawn from."""
    from zeggs_tpu_torch.train.loop import make_train_step

    graphed = _small_trainer(small_run, tmp_path / "g", {"learning_rate": 0.0})
    eager = _small_trainer(small_run, tmp_path / "e", {"learning_rate": 0.0})
    _, plain = make_train_step(eager.opts, eager.ds.stats, eager.ds.parents, eager.ds.dt,
                               eager.nets)
    default = torch.cuda.default_generators[graphed.device.index or 0]
    offset = default.get_offset()
    inputs = graphed._batch(*_draws(graphed, 1)[0])
    ours, ref = [], []
    for i in range(5):
        ours.append(graphed.train_step(inputs)["total_loss"].item())
        ref.append(plain(_device_batch(eager, inputs), i, eager.generator)["total_loss"].item())
        assert graphed.generator.get_offset() == eager.generator.get_offset()
    assert len(set(ours[1:])) == 4  # the replays
    np.testing.assert_allclose(ours, ref, rtol=2e-5)
    assert default.get_offset() == offset


def test_a_train_step_that_cannot_be_captured_raises(small_run, tmp_path, monkeypatch):
    """A host sync injected into the loss: the eager first step runs, the
    capture of the second raises instead of falling back, and a new
    trainer captures afterwards."""
    from zeggs_tpu_torch.train import loop

    compute_loss = loop.compute_loss

    def syncing(*args, **kw):
        loss, metrics = compute_loss(*args, **kw)
        loss.item()  # waits for the card: not allowed while capturing
        return loss, metrics

    monkeypatch.setattr(loop, "compute_loss", syncing)
    trainer = _small_trainer(small_run, tmp_path / "a")
    draws = _draws(trainer, 2)
    trainer.train_step(trainer._batch(*draws[0]))
    with pytest.raises(RuntimeError, match="capturing the train step"):
        trainer.train_step(trainer._batch(*draws[1]))
    monkeypatch.undo()
    trainer = _small_trainer(small_run, tmp_path / "b")
    for idx, ewl in draws:
        metrics = trainer.train_step(trainer._batch(idx, ewl))
    assert len(trainer.program.graphs) == 1 and np.isfinite(metrics["total_loss"].item())


def test_synthesis_after_a_train_step_uses_the_new_weights(small_run, tmp_path, monkeypatch):
    """Sample synthesis, one graphed train step, synthesis again: the second
    synthesis's rollouts differ from the first and equal the eager rollout
    of the updated weights within 1e-6 (each synthesis makes its own
    programs); the first launches the GRU cell once a decoder step and once
    a program's capture."""
    from zeggs_tpu_torch.infer.programs import ProgramCache
    from zeggs_tpu_torch.train import loop

    trainer = _small_trainer(small_run, tmp_path)
    for idx, ewl in _draws(trainer, 2):  # past the capture
        trainer.train_step(trainer._batch(idx, ewl))
    recorded, original = [], ProgramCache.rollout

    def recording(self, *args, **kw):
        out = original(self, *args, **kw)
        recorded.append(out[2].cpu())  # lpos
        return out

    class Eager:
        """The eager `decoder.rollout` in `ProgramCache`'s place."""

        def __init__(self, dec, stats, dt):
            self.dec, self.dt = dec, dt
            self.stats = [stats[k] for k in ("anim_input_mean", "anim_input_std",
                                             "anim_output_mean", "anim_output_std")]

        def rollout(self, state0, gaze, speech, style):
            out = D.rollout(self.dec, *state0, gaze, speech, style, *self.stats, self.dt,
                            output_indices=(0, 1, 4, 5))
            recorded.append(out[2].cpu())
            return out

        def programs(self):
            return []

    monkeypatch.setattr(ProgramCache, "rollout", recording)
    before = GC.launches
    steps, programs = trainer.generate_samples(1, 2)
    torch.cuda.synchronize()
    assert GC.launches - before == steps + programs and programs > 0
    first = list(recorded)
    trainer.train_step(trainer._batch(*_draws(trainer, 1, seed=5)[0]))
    recorded.clear()
    trainer.generate_samples(1, 2)
    second = list(recorded)
    recorded.clear()
    monkeypatch.setattr(loop, "ProgramCache", Eager)
    trainer.generate_samples(1, 2)
    assert len(first) == len(second) == len(recorded) == 2
    assert all(not torch.equal(a, b) for a, b in zip(first, second))
    assert _worst(second, recorded) <= 1e-6


def test_griffin_lim_on_the_card_matches_the_cpu(device):
    cfg = _mel_cfg(800)
    x = torch.as_tensor(_speech_like(2.0, 5), device=device)
    mel_db = M.mel_spectrogram_tts(x, cfg)
    amp = M.db_to_amplitude(M.denormalize_range(mel_db, cfg.min_clipping / cfg.filter_length))
    mag = M.mel_to_linear(amp, cfg.sampling_rate, 800, cfg.mel_fmin, cfg.mel_fmax)
    n = int(mag.shape[0] * cfg.hop_length + 800)
    signal = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    y = M.griffin_lim(mag, cfg.hop_length, 800, 30, signal=signal).cpu().numpy()
    ref = M.griffin_lim(mag.cpu(), cfg.hop_length, 800, 30, signal=signal).numpy()
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-4


def test_one_nccl_process_on_the_card(device, monkeypatch):
    import socket

    from zeggs_tpu_torch.parallel import distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setattr(distributed, "DEFAULT_TIMEOUT_S", 120)
    assert distributed.initialize(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        assert distributed.process_device("cuda") == torch.device("cuda", 0)
        probe = torch.full((3,), 2.0, device=device)
        torch.distributed.all_reduce(probe)
        distributed.barrier()
        assert probe.tolist() == [2.0, 2.0, 2.0]
    finally:
        torch.distributed.destroy_process_group()


def test_profiler_sections_are_graphed(device):
    """The profilers' sections on the card: each captured as a CUDA graph of
    kernels, timed eagerly and replayed (v1 width)."""
    from zeggs_tpu_torch.profilers import loss_profile

    out = loss_profile.main(["loss", "fk", "--reps", "2"])
    for name in ("loss", "fk"):
        r = out[name]
        assert r["kernels"] > 0, name
        for t in (r["eager"], r["graphed"]):
            assert t["n"] == 2 and t["host_ms"] > 0 and t["device_ms"] > 0, (name, t)


def test_a_profiler_capture_that_fails_raises(device):
    from zeggs_tpu_torch.profilers import common

    x = torch.ones(4, device=device)
    with pytest.raises(RuntimeError, match="capturing a host sync"):
        common.Graphed(lambda: float(x.sum()), device, "a host sync")


def test_fused_b1_profile_launches_every_kernel(device):
    """The B=1 profile on a 1 s clip at v1 width: the scan replays the
    rollout programs (GRU-cell launches) and equals the eager float32
    rollout within 1e-6; the decoder kernel runs at bf16 and at int8."""
    from zeggs_tpu_torch.profilers import fused_b1_profile

    out = fused_b1_profile.main(["1", "--reps", "2"])
    assert out["scan_launches"]["gru_cell"] > 0
    assert out["fused_bf16_launches"]["decoder_rollout"] > 0
    assert out["fused_int8_launches"]["decoder_rollout"] > 0
    assert max(m["scan"] for m in out["mae"].values()) <= 1e-6
    assert out["cell_weights"] == 18_910_208


def test_roofline_of_the_v1_step(device):
    from zeggs_tpu_torch.profilers import train_roofline

    out = train_roofline.roofline("bfloat16", device, measured_ms=300.0)
    assert out["cell_params"] == 18_910_208 and out["bytes_accessed"] is None
    # the decoder cell's products alone: 255 steps of B=32, forward and backward
    assert out["flops"] > 3 * 2 * 32 * 255 * 18_910_208
    assert 0 < out["fraction_of_bound"] < 1
