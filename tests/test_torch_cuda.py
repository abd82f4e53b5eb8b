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
unsharded run, its GRU-cell launches counted on the mesh's threads. End to
end on the card, with every kernel's launches counted (`utils.profiling`'s
``<kernel>.launches``): the generate CLI's CSV, batched and int8 paths with
example and label styles, batched requests against single ones; a request
against the CPU; a streaming session against the offline request; the
daemon's coalesced /synthesize (also over a mesh) and a stream over HTTP;
only copies after a chunk's finish program; the corpus pipeline's mel
launches; two processes sharing the card against one. The bake program
(the BVH's channels of a 16 x 1024 chunk at 75 joints) against the stage
on the CPU (positions 1e-4 cm, Euler degrees 1e-3 where well
conditioned), a replay bit for bit the eager stage. The inference
decoder step's kernels (csrc/decoder_step.cu: the pose in and out, the ELU
with FiLM's scale and shift, GRU0's gates) give the plain step's outputs
bit for bit at B=1 to 2048 for both cells, 4 launches a ``normal`` step and
5 a FiLM step (none where autograd records), and a 16-step program replays
the eager chunk bit for bit. The rollout
programs (CUDA graphs of the decoder step) equal the eager chunk within
1e-6, count their replays' launches, raise where the step cannot be
captured, and give the single-thread result when two threads replay at
once; the FiLM cell's too, at v2's widths, and against its unhoisted
plain step within pose MAE 1e-3; a FiLM job of the benchmark's
``v2film.offline`` set-up replays every step, counted, and captures
nothing after set-up. The train program (CUDA graphs of the train
step) equals the plain step over three steps under every training option
(bit for bit with cuDNN's deterministic algorithms, within rtol 2e-5 /
atol 1e-6 with its default ones), draws fresh noise at each replay from
the registered generator, resumes losslessly and raises where the step
cannot be captured; sample synthesis after a train step replays the new
weights. Generation from the reference's `.pt` pickles writes the same BVH
text as from the `.npz` files; Griffin-Lim on the card against the CPU from
the same first signal: relative L2 error 1e-4 (tests/test_torch_misc.py's
bound); a job's first poses featurized in one pass equal each clip
featurized alone, bit for bit; one NCCL process comes up on the card. The profilers capture every
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
from zeggs_tpu_torch.ops.kernels import build
from zeggs_tpu_torch.ops.kernels import decoder_rollout as DR
from zeggs_tpu_torch.config import MelConfig
from zeggs_tpu_torch.ops import mel as M
from zeggs_tpu_torch.ops.kernels import gru_cell as GC
from zeggs_tpu_torch.ops.kernels import mel as MK

pytestmark = pytest.mark.cuda

DT = 1.0 / 60.0
MEL_N_FFTS = [800, 1024, 802]
#: the requests of the end-to-end tests: at the default bucket of 512
#: frames the 4 s clip is a chunk of its own, the 10 and 12 s clips one
#: chunk of two at T_pad 1024
CLIPS = {"clip_04s": 4.0, "clip_10s": 10.0, "clip_12s": 12.0}


def _launches(kernel):
    """``kernel``'s launches in this process so far (`build.launches`)."""
    return build.launches()[kernel]


def _counts(**launched):
    """{kernel: launches} over every kernel, 0 where ``launched`` names none."""
    return {k: launched.get(k, 0) for k in build.KERNELS}


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
    before = _launches("decoder_rollout")
    rows = DR.rollout_b1(*args)
    torch.cuda.synchronize()
    assert _launches("decoder_rollout") == before + 1
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
    before = _launches("decoder_rollout")
    out = fn(state0, *cond)
    torch.cuda.synchronize()
    assert _launches("decoder_rollout") == before + 1
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
    before = _launches("decoder_rollout")
    with pytest.raises(ValueError, match="does not fit"):
        _kernel_and_plain(dec, stats, state0, cond, torch.float32)
    assert _launches("decoder_rollout") == before


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
    before = _launches("gru_cell")
    out = GC.fused_gru_cell(p, x, h)
    torch.cuda.synchronize()
    assert _launches("gru_cell") == before + 1
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
    before = _launches("gru_cell")
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
    assert _launches("gru_cell") == before


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
    before = _launches("mel_spectrogram")
    out = M.mel_spectrogram_tts(x, cfg)
    torch.cuda.synchronize()
    assert _launches("mel_spectrogram") == before + 1
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
    before = _launches("mel_spectrogram")
    with pytest.raises(TypeError):
        MK.mel_frames(torch.zeros(1000, device=device, dtype=torch.float64), 2, MelConfig())
    with pytest.raises(ValueError):
        MK.mel_frames(torch.zeros(999, device=device), 2, MelConfig())
    assert _launches("mel_spectrogram") == before


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
    before = _launches("mel_spectrogram")
    err = MK._library().zeggs_mel_spectrogram(
        x.data_ptr(), 5, c.window.data_ptr(), c.stages.data_ptr(), c.twiddles.data_ptr(),
        c.twiddles.shape[0], c.filters.data_ptr(), c.filters.shape[1], c.support.data_ptr(),
        out.data_ptr(), c.n_fft, c.hop, c.n_mels, c.amp_scale, c.min_amp, c.dyn_range, 1,
        len(c.plan.radices), 1, 0, x.data_ptr(), 64, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="invalid argument"):
        MK._raise_for(err)
    assert _launches("mel_spectrogram") == before


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
    before = _launches("mel_spectrogram")
    out = MK.mel_frames(x, nf, cfg)
    torch.cuda.synchronize()
    assert _launches("mel_spectrogram") == before + 1
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
    before = _launches("gru_cell")
    with pytest.raises(RuntimeError, match="inference only"):
        GC.pack_gru(cell)
    with torch.no_grad():
        packed = GC.pack_gru(cell)
    with pytest.raises(RuntimeError, match="inference only"):
        GC.fused_gru_cell(packed, x.requires_grad_(), h)
    assert _launches("gru_cell") == before


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

    before = _launches("gru_cell")
    threads = [threading.Thread(target=launch) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert _launches("gru_cell") == before + 4 * n
    assert len(errors) == 4 and max(errors) <= 2e-5



def _program_case(device, B=4, T=41, njoints=16, hidden=256, seed=21):
    """A decoder of PyTorch-default initialisation on the card, its pose
    statistics and the carry and (B, T - 1) conditioning of a chunk."""
    dec, stats, state0, (gaze, speech, style) = _rollout_case(device, B, T, njoints, hidden, seed)
    with torch.inference_mode():
        carry = D.init_carry(dec, *state0, gaze[:, 0], style[:, 0],
                             *list(stats.values())[:2])
    return dec, stats, carry, (gaze[:, 1:], speech[:, 1:], style[:, 1:])


def _rollout_case(device, B=4, T=41, njoints=16, hidden=256, seed=21, rnn_cond="normal",
                  style_size=64):
    """The decoder and statistics of `_program_case`, the frame-0 state and
    the (B, T) conditioning of a rollout."""
    from zeggs_tpu_torch.infer.programs import _STATS

    pose_in, pose_out = 6 + njoints * 15 + 3, 6 + njoints * 15
    torch.manual_seed(seed)
    dec = D.Decoder(pose_in, pose_out, 64, style_size, hidden, 2, rnn_cond).to(device)
    dec = dec.eval().requires_grad_(False)
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32), device=device)

    stats = (t(pose_in, scale=0.1), t(pose_in).abs() + 0.5, t(pose_out, scale=0.1),
             t(pose_out).abs() * 0.2 + 0.05)
    q = t(B, 4)
    state0 = (t(B, 3), q / q.norm(dim=-1, keepdim=True), t(B, 3, scale=0.1), t(B, 3, scale=0.1),
              t(B, njoints, 3), t(B, njoints, 2, 3), t(B, njoints, 3, scale=0.1),
              t(B, njoints, 3, scale=0.1))
    gaze, speech, style = t(B, T, 3, scale=100.0), t(B, T, 64), t(B, T, style_size)
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


def _unpacked(t):
    """``t``'s values in a view whose rows are not packed (every stride
    doubled), as a caller's state may come."""
    u = torch.empty(t.shape + (2,), dtype=t.dtype, device=t.device)[..., 0]
    return u.copy_(t)


def _step_args(dec, stats, state0, cond, njoints):
    """The step of ``dec`` and its arguments at frame 1: the carry from
    frame 0 (GRU0's hidden state a view with a row stride, as
    `rollout_chunk` passes it; the root velocity and the joint velocities
    views whose rows are not packed) and one column of the gaze and of the
    cell's conditioning."""
    gaze, speech, style = cond
    state0 = tuple(_unpacked(t) if i in (2, 6) else t for i, t in enumerate(state0))
    carry = D.init_carry(dec, *state0, gaze[:, 0], style[:, 0], *list(stats.values())[:2])
    conditioning, step, plain = D.chunk_step(dec, *stats.values(), DT, njoints)
    cols = tuple(c[:, 0] for c in conditioning(speech[:, 1:], style[:, 1:]))
    return step, plain, (gaze[:, 1], *cols, carry[0][0], carry[0][1].contiguous(), *carry[1:])


@pytest.mark.parametrize("hidden", [1024, 24])
@pytest.mark.parametrize("B", [1, 2, 16, 64, 2048])
@pytest.mark.parametrize("rnn_cond", ["normal", "film"])
def test_kernel_step_equals_the_plain_step_bit_for_bit(device, monkeypatch, rnn_cond, B, hidden):
    """One inference step with its element-wise math through the step's
    kernels (`ops/kernels/decoder_step.py`) against the same step with
    their plain versions on the card, the step as it ran before the
    kernels: 75 joints, a non-identity root, state views of any strides;
    every output equal bit for bit. The kernel step launches 4 of them (FiLM
    5) and one GRU cell, the plain step the GRU cell alone."""
    from zeggs_tpu_torch.ops.kernels import decoder_step as DS

    dec, stats, state0, cond = _rollout_case(device, B, 2, 75, hidden, 5, rnn_cond)
    with torch.inference_mode():
        step, plain, args = _step_args(dec, stats, state0, cond, 75)
        before = build.launches()
        got = step(*args)
        torch.cuda.synchronize()
        launched = [build.launches_since(before)]
        monkeypatch.setattr(DS, "step_ops", lambda state, plain: DS.PlainOps)
        before = build.launches()
        want = step(*args)
        torch.cuda.synchronize()
        launched.append(build.launches_since(before))
    assert not plain
    assert launched == [_counts(gru_cell=1, decoder_step=5 if rnn_cond == "film" else 4),
                        _counts(gru_cell=1)]
    assert len(got) == len(want) == 10
    for i, (g, w) in enumerate(zip(got, want)):
        unequal = int((g != w).sum())
        assert g.shape == w.shape and unequal == 0, (i, unequal, (g - w).abs().max().item())


def test_the_step_launches_none_of_its_kernels_where_autograd_records(device):
    """With autograd recording on the decoder, the step is the plain
    differentiable math: no kernel launches, and its gradient flows."""
    dec, stats, state0, cond = _rollout_case(device, 3, 2, 16, 64)
    dec.requires_grad_(True)
    step, plain, args = _step_args(dec, stats, state0, cond, 16)
    before = build.launches()
    out = step(*args)
    out[4].square().sum().backward()
    torch.cuda.synchronize()
    assert plain and build.launches_since(before) == _counts()
    assert dec.cell.layer0.weight.grad is not None


@pytest.mark.parametrize("rnn_cond", ["normal", "film"])
def test_a_16_step_program_replays_the_eager_chunk_bit_for_bit(device, rnn_cond):
    """A 16-step chunk of 16 rows at v2's widths (75 joints, H 1024) through
    the program cache against the eager chunk on the card: trajectories and
    carry equal bit for bit; the capture's warm-up step and the 16 replayed
    ones each launch the GRU cell once and the step's kernels 4 times (FiLM
    5)."""
    from zeggs_tpu_torch.infer.programs import ProgramCache

    film = rnn_cond == "film"
    dec, stats, state0, cond = _rollout_case(device, 16, 17, 75, 1024, 9, rnn_cond,
                                             19 if film else 64)
    with torch.inference_mode():
        carry = D.init_carry(dec, *state0, cond[0][:, 0], cond[2][:, 0],
                             *list(stats.values())[:2])
        chunk = tuple(c[:, 1:] for c in cond)
        ref_carry, ref = _eager_chunk(dec, stats, carry, chunk)
        before = build.launches()
        got_carry, got = ProgramCache(dec, stats, DT).rollout_chunk(carry, *chunk)
        torch.cuda.synchronize()
    per_step = 5 if film else 4
    assert build.launches_since(before) == _counts(gru_cell=17, decoder_step=per_step * 17)
    for i, (g, r) in enumerate(zip(got + got_carry, ref + ref_carry)):
        assert g.shape == r.shape and torch.equal(g, r), (i, (g - r).abs().max().item())


def test_film_graphs_equal_the_eager_film_rollout(device):
    """The FiLM cell at v2's widths (75 joints, H 1024, speech 64, 19
    labels), 4 rows and 41 frames, through the program cache: against the
    eager `rollout_chunk` on the card within 1e-6 (bitwise expected: the
    same kernels on the same inputs); against `rollout_film` (the unhoisted
    plain step, GRU1 by cuBLAS) within pose MAE 1e-3 (docs/DESIGN.md section
    5); GRU1 of every step (and of each capture's warm-up step) through the
    GRU-cell kernel and its element-wise math through the step's 5 kernels,
    every step counted in ``programs.rollout_steps``."""
    from zeggs_tpu_torch.infer.programs import ProgramCache, ladder_programs
    from zeggs_tpu_torch.utils import profiling

    dec, stats, state0, cond = _rollout_case(device, njoints=75, hidden=1024, rnn_cond="film",
                                             style_size=19)
    n = cond[0].shape[1] - 1
    with torch.inference_mode():
        carry = D.init_carry(dec, *state0, cond[0][:, 0], cond[2][:, 0],
                             *list(stats.values())[:2])
        chunk = tuple(c[:, 1:] for c in cond)
        ref_carry, ref = _eager_chunk(dec, stats, carry, chunk)
        _, plain = D.rollout_film(dec, carry, *chunk, *stats.values(), DT,
                                  output_indices=(0, 1, 4, 5))
        before, steps = build.launches(), profiling.counters().get("programs.rollout_steps", 0)
        got_carry, got = ProgramCache(dec, stats, DT).rollout_chunk(carry, *chunk)
        torch.cuda.synchronize()
    launched = build.launches_since(before)
    err = max(_max_diff(got, ref), _max_diff(got_carry, ref_carry))
    mae = max((g - p).abs().mean().item() for g, p in zip(got, plain))
    print(f"FiLM graphs against the eager chunk: max|diff| {err:.3e}; against rollout_film: "
          f"MAE {mae:.3e}")
    assert err <= 1e-6 and mae < 1e-3
    assert launched == _counts(gru_cell=n + ladder_programs([n]),
                               decoder_step=5 * (n + ladder_programs([n])))
    assert profiling.counters()["programs.rollout_steps"] - steps == n


def test_a_film_job_replays_the_programs(device):
    """`generate_batch` at v2's widths with a FiLM decoder (the benchmark's
    ``v2film.offline`` set-up over 4 clips of 5-11 s: chunks of 2 rows at
    512 and 1,024 frames): for each of two jobs after set-up, the GRU-cell
    kernel's launches and ``programs.rollout_steps`` equal the chunks' T_pad
    - 1 steps, the step kernels' launches 5 times as many,
    ``programs.rollout_device_s`` grows, and
    ``programs.captures`` does not; the written clips agree with the plain
    reference within the cell's limits."""
    from benchmark.common import Cell
    from benchmark.run import generator_of
    from zeggs_tpu_torch.utils import profiling

    cell = Cell("v2film.offline")
    cell.mix = dict(cell.mix, lines=4, check_samples=2)
    run = generator_of(cell).Run(cell, cell.config, 2**31 + 33, device)
    run.setup()
    try:
        assert run.pipe.networks["decoder"].rnn_cond == "film"
        steps = sum(n for _, n in run.decoder_steps())
        assert [T for T, _ in run.shapes] == [512, 1024] and steps == 1534
        for k in range(2):
            before = profiling.counters()
            run.jobs.append(run._job(k)[:2])
            after = profiling.counters()
            grew = {key: after.get(key, 0) - before.get(key, 0)
                    for key in ("gru_cell.launches", "decoder_step.launches",
                                "programs.rollout_steps", "programs.rollout_device_s",
                                "programs.captures")}
            print(f"FiLM job {k}: {grew}")
            assert grew["gru_cell.launches"] == grew["programs.rollout_steps"] == steps
            assert grew["decoder_step.launches"] == 5 * steps
            assert grew["programs.rollout_device_s"] > 0 and grew["programs.captures"] == 0
        run.release()
        checks = run.check()
    finally:
        run.close()
    print(f"FiLM jobs against the reference: {checks}")
    assert all(c["value"] <= c["limit"] for c in checks.values())


def test_a_v2_job_launches_the_step_kernels_four_times_a_step(device):
    """`generate_batch` at v2's widths with the ``normal`` decoder (the
    benchmark's ``v2.offline`` set-up over 4 clips of 5-11 s: chunks of 2
    rows at 512 and 1,024 frames): for each of two jobs after set-up, the
    step kernels' launches are 4 times ``programs.rollout_steps``, which
    equals the GRU-cell kernel's launches and the chunks' T_pad - 1 steps,
    and nothing is captured; the written clips agree with the plain
    reference within the cell's limits."""
    from benchmark.common import Cell
    from benchmark.run import generator_of
    from zeggs_tpu_torch.utils import profiling

    cell = Cell("v2.offline")
    cell.mix = dict(cell.mix, lines=4, check_samples=2)
    run = generator_of(cell).Run(cell, cell.config, 2**31 + 35, device)
    run.setup()
    try:
        assert run.pipe.networks["decoder"].rnn_cond == "normal"
        steps = sum(n for _, n in run.gru_calls())
        assert [T for T, _ in run.shapes] == [512, 1024] and steps == 1534
        for k in range(2):
            before = profiling.counters()
            run.jobs.append(run._job(k)[:2])
            after = profiling.counters()
            grew = {key: after.get(key, 0) - before.get(key, 0)
                    for key in ("gru_cell.launches", "decoder_step.launches",
                                "programs.rollout_steps", "programs.captures")}
            print(f"v2 job {k}: {grew}")
            assert grew["gru_cell.launches"] == grew["programs.rollout_steps"] == steps
            assert grew["decoder_step.launches"] == 4 * steps and grew["programs.captures"] == 0
        run.release()
        checks = run.check()
    finally:
        run.close()
    print(f"v2 jobs against the reference: {checks}")
    assert all(c["value"] <= c["limit"] for c in checks.values())


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


def test_bake_graph_equals_the_stage_on_the_cpu(device):
    """The bake program for a chunk of 16 x 1024 frames at v1's 75 joints,
    on unit quaternions and positions at the scale of a rollout, against
    the same stage (`programs.bake`) on the CPU: positions within 1e-4 cm;
    rotations, as the matrices of their Euler angles, within 1e-4
    everywhere (float32's own error: 2.3e-5 against float64 on the CPU, at
    the asin of gimbal lock), and as Euler degrees within 1e-3 where the
    decomposition is well conditioned (|cos pitch| >= 0.05: an ulp of a
    quaternion turns yaw and roll by at most ~20 ulps there; at gimbal lock
    by any amount, on the host path as on the card). A replay equals the
    eager stage on the card bit for bit."""
    from zeggs_tpu_torch.infer.programs import FinishProgram, bake
    from zeggs_tpu_torch.ops import quat

    B, T, J = 16, 1024, 75
    g = torch.Generator().manual_seed(31)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    def unit(*shape):
        q = draw(*shape, 4)
        return q / q.norm(dim=-1, keepdim=True)

    host = (draw(B, T, 3, scale=100.0), unit(B, T), draw(B, T, J, 3, scale=10.0), unit(B, T, J))
    on_card = tuple(t.to(device) for t in host)
    with torch.inference_mode():
        program = FinishProgram(on_card, bake)
        got = program.run(on_card)
        eager = bake(on_card)
        torch.cuda.synchronize()
        want = bake(host)
    assert [tuple(t.shape) for t in got] == [(B, T, J, 3), (B, T, J, 3)]
    assert all(t.dtype == torch.float32 for t in got)
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
    positions, rotations = (t.cpu() for t in got)
    assert (positions - want[0]).abs().max() <= 1e-4

    def matrices(deg):
        return quat.to_xform(quat.from_euler(torch.deg2rad(deg.double()), "zyx"))

    assert (matrices(rotations) - matrices(want[1])).abs().max() <= 1e-4
    degrees = ((rotations - want[1] + 180.0) % 360.0 - 180.0).abs()
    conditioned = torch.cos(torch.deg2rad(want[1][..., 1])).abs() >= 0.05
    print(f"bake, card against CPU: positions {(positions - want[0]).abs().max():.3e} cm, "
          f"degrees {degrees[conditioned].max():.3e} (all {degrees.max():.3e})")
    assert degrees[conditioned].max() <= 1e-3


def test_launch_counter_counts_replays(device):
    """A capture adds nothing and its one eager warm-up step adds one
    GRU-cell launch and 4 of the step's kernels; each replay adds the
    launches its graph captured. 40 steps: the 16- and 4-step programs, 40 +
    2 GRU-cell launches at the first call, 40 at the next, and 4 times as
    many of the step's kernels."""
    from zeggs_tpu_torch.infer.programs import ProgramCache

    dec, stats, carry, cond = _program_case(device)
    cache = ProgramCache(dec, stats, DT)
    counts = []
    with torch.inference_mode():
        for _ in range(2):
            before = build.launches()
            cache.rollout_chunk(carry, *cond)
            counts.append(build.launches_since(before))
    assert counts == [_counts(gru_cell=42, decoder_step=168),
                      _counts(gru_cell=40, decoder_step=160)]
    assert sorted(p.counts["gru_cell.launches"] for _, p in cache.programs()) == [4, 16]
    assert sorted(p.counts["decoder_step.launches"] for _, p in cache.programs()) == [16, 64]


def test_an_uncapturable_step_raises(device, monkeypatch):
    """A host sync inside the step (injected into the pose integration, the
    step's `pose_out` kernel) makes the capture fail: the rollout raises
    instead of returning the eager result, and the card keeps working
    afterwards."""
    from zeggs_tpu_torch.infer.programs import ProgramCache
    from zeggs_tpu_torch.ops.kernels import decoder_step as DS

    dec, stats, carry, cond = _program_case(device)
    integrate = DS.CudaOps.pose_out

    def syncing(*args, **kw):
        out = integrate(*args, **kw)
        out[0].sum().item()  # waits for the card: not allowed while capturing
        return out

    monkeypatch.setattr(DS.CudaOps, "pose_out", staticmethod(syncing))
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
    """One deterministic small-width step on the card against the CPU; no
    inference kernel launches inside it (the decoder step's kernels
    neither), and the ``normal`` cell's rollout runs the training rollout's
    kernels on the card (none on the CPU)."""
    case = _train_case(rnn_cond)
    grads = {}
    for dev in ("cpu", device):
        before = build.launches()
        grads[str(dev)] = _step(*case, dev)[1]
        launched = build.launches_since(before)
        assert launched == _counts(decoder_train=launched["decoder_train"])
        assert (launched["decoder_train"] > 0) == (dev == device and rnn_cond == "normal")
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
    data directory, a style BVH, a 2 s WAV and the WAVs of CLIPS."""
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
    for i, (clip, seconds) in enumerate(CLIPS.items()):
        wav.write_wavefile(root / f"{clip}.wav", _speech_like(seconds, 30 + i), 16000)
    opts = Options.from_options_dict({"net_opt": {"style_encoder": {"nhidden": 24,
                                                                    "style_encoding_size": 8}}})
    return dict(root=root, data=data, opts=opts)


def test_generation_from_reference_checkpoints_on_the_card(small_models, tmp_path):
    from zeggs_tpu_torch.infer import GesturePipeline, generate_gesture

    m, texts = small_models, {}
    for tag in ("npz", "pt"):
        pipe = GesturePipeline(m["root"] / tag, m["data"], options=m["opts"], device="cuda")
        before = build.launches()
        generate_gesture(m["root"] / "audio.wav", [(m["root"] / "style.bvh", None)], None, None,
                         tmp_path, file_name=tag, seed=3, pipeline=pipe)
        torch.cuda.synchronize()
        launched = build.launches_since(before)
        assert (launched["decoder_rollout"], launched["mel_spectrogram"]) == (1, 1)
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
        before = build.launches()
        generate_gesture(m["root"] / "audio.wav", ["B"], None, None, tmp_path,
                         style_encoding_type="label", first_pose=m["root"] / "style.bvh",
                         file_name=tag, pipeline=pipe)
        torch.cuda.synchronize()
        launched[tag] = build.launches_since(before)
    assert launched == {"cpu": _counts(), "cuda": _counts(decoder_rollout=1, mel_spectrogram=1)}
    a, b = bvh.load(tmp_path / "cpu.bvh"), bvh.load(tmp_path / "cuda.bvh")
    assert a["rotations"].shape == b["rotations"].shape and np.isfinite(b["rotations"]).all()
    assert np.abs(a["positions"] - b["positions"]).mean() < 1e-3
    assert np.abs(a["rotations"] - b["rotations"]).mean() < 1e-3


def test_generate_batch_over_a_mesh_on_the_card(small_models, tmp_path, monkeypatch):
    """Three requests as one chunk over two replicas on cuda:0 and, with
    several cards, over every card, at fp32 rollout weights: each BVH within
    the pose MAE budget of 1e-3 of the run without a mesh; with the mesh's
    programs captured first by `warmup`, GRU-cell launches = decoder steps
    x blocks (the chunk padded to a multiple of the mesh) and 4 step-kernel
    launches each, no decoder launch, one mel launch a request; the GRU
    cell's and the step kernels' launches counted on the mesh's block
    threads, the mel kernel's on the caller's."""
    import threading

    from zeggs_tpu_torch.infer import GesturePipeline
    from zeggs_tpu_torch.infer.batch import SHARD_THREADS, Request, generate_batch, warmup
    from zeggs_tpu_torch.io import bvh
    from zeggs_tpu_torch.parallel import create_mesh
    from zeggs_tpu_torch.utils import profiling

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
    sites, count, replayed = set(), profiling.count, profiling.replayed

    def site(names):
        thread = threading.current_thread().name
        sites.update((name, "block" if thread.startswith(SHARD_THREADS) else "caller")
                     for name in names if name.endswith(".launches"))

    monkeypatch.setattr(profiling, "count", lambda name, n=1: (site([name]), count(name, n)))
    monkeypatch.setattr(profiling, "replayed", lambda counts: (site(counts), replayed(counts)))
    for k, mesh in enumerate(meshes):
        warmup(pipe, [n] * len(reqs), bucket=64, mesh=mesh)
        before = build.launches()
        sites.clear()
        generate_batch(pipe, reqs, tmp_path / f"mesh{k}", bucket=64, mesh=mesh)
        torch.cuda.synchronize()
        launched = build.launches_since(before)
        assert launched == _counts(gru_cell=steps * mesh.size, decoder_step=4 * steps * mesh.size,
                                   mel_spectrogram=3), (mesh, launched)
        assert sites == {("gru_cell.launches", "block"), ("decoder_step.launches", "block"),
                         ("mel_spectrogram.launches", "caller")}
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
    tests/test_batch_infer.py's float16 bounds, each chunk pulling the bytes
    it pulls at float32: the float32 channels that its bake program
    computes on the card."""
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
    pull, pulled = B._pull, {}

    def recorded(out):
        pulled[tag].append(sum(o.numel() * o.element_size() for o in out))
        return pull(out)

    monkeypatch.setattr(B, "_pull", recorded)
    for tag, (dtype, depth, mesh) in runs.items():
        monkeypatch.setattr(B, "PIPELINE_DEPTH", depth)
        pipe = GesturePipeline(m["root"] / "npz", m["data"], options=m["opts"], device="cuda",
                               rollout_weights="float32", transfer_dtype=dtype)
        pulled[tag] = []
        written = generate_batch(pipe, reqs, tmp_path / tag, bucket=64, max_batch=2, mesh=mesh)
        assert [p.name for p in written] == names, tag
    assert len(pulled["depth2"]) == 4
    assert pulled["depth2"] == pulled["float16"]
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


def _bvh_mae(a_path, b_path):
    """(position MAE, Euler angle MAE) of two BVHs of one length; the second
    must be finite."""
    from zeggs_tpu_torch.io import bvh

    a, b = bvh.load(a_path), bvh.load(b_path)
    assert a["rotations"].shape == b["rotations"].shape, b_path.name
    assert np.isfinite(b["positions"]).all() and np.isfinite(b["rotations"]).all(), b_path.name
    return (float(np.abs(a["positions"] - b["positions"]).mean()),
            float(np.abs(a["rotations"] - b["rotations"]).mean()))


def _requests_csv(m, path, style):
    """A generate CLI CSV of the CLIPS: each styled by the style BVH, or by
    a label with the style BVH as first pose."""
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["base_path", "audio", "style", "file_name", "temperature", "seed",
                    "use_gpu", "frames", "first_pose", "generate"])
        for i, clip in enumerate(CLIPS):
            label = style == "label"
            w.writerow([str(m["root"]), f"{clip}.wav", "AB"[i % 2] if label else "style.bvh",
                        clip, "1.0", str(40 + i), "TRUE", "", "style.bvh" if label else "",
                        "TRUE"])
    return path


@pytest.mark.parametrize("style", ["example", "label"])
def test_generate_cli_paths_on_the_card(small_models, tmp_path, style):
    """The generate CLI over CLIPS on the card, each kernel's launches
    counted around each run: CSV mode (a decoder launch a request), `-b`
    (the 4 s clip one decoder launch, the 10 and 12 s clips one chunk of
    1023 steps replayed from the rollout programs: a GRU-cell launch and 4
    step-kernel launches a step and one eager warm-up step a program) and
    `--int8` (a decoder launch a
    request); one mel launch a request on every path; every BVH finite, at
    60 fps, of its clip's length. Then at fp32 rollout weights the batched
    requests against single requests: pose MAE < 1e-3."""
    import csv
    import json

    from zeggs_tpu_torch.cli import generate as cli
    from zeggs_tpu_torch.infer import GesturePipeline, generate_gesture
    from zeggs_tpu_torch.infer.batch import generate_batch
    from zeggs_tpu_torch.infer.programs import ladder_programs
    from zeggs_tpu_torch.io import bvh

    m, n = small_models, len(CLIPS)
    models = m["root"] / ("npz" if style == "example" else "label")
    options = tmp_path / "options.json"
    options.write_text(json.dumps({**m["opts"].to_options_dict(), "paths": {
        "base_path": str(m["data"].parent), "path_processed_data": m["data"].name,
        "output_dir": str(tmp_path), "models_dir": str(models)}}))
    requests = _requests_csv(m, tmp_path / "requests.csv", style)
    chunk = 1024 - 1
    runs = {"csv": ([], {"decoder_rollout": n}),
            "batched": (["-b"], {"decoder_rollout": 1,
                                 "gru_cell": chunk + ladder_programs([chunk]),
                                 "decoder_step": 4 * (chunk + ladder_programs([chunk]))}),
            "int8": (["--int8"], {"decoder_rollout": n})}
    for tag, (flags, expected) in runs.items():
        before = build.launches()
        cli.main(["-o", str(options), "-c", str(requests), "-p", str(tmp_path / tag),
                  "--device", "cuda", "-se", style, *flags])
        torch.cuda.synchronize()
        want = {k: 0 for k in build.KERNELS} | expected | {"mel_spectrogram": n}
        assert build.launches_since(before) == want, tag
        for clip, seconds in CLIPS.items():
            anim = bvh.load(tmp_path / tag / f"{clip}.bvh")
            assert anim["rotations"].shape[0] == round(60 * seconds), (tag, clip)
            assert abs(anim["frametime"] - DT) < 1e-6, (tag, clip)
            assert np.isfinite(anim["rotations"]).all(), (tag, clip)
            assert np.isfinite(anim["positions"]).all(), (tag, clip)

    pipe = GesturePipeline(models, m["data"], options=m["opts"], style_encoding_type=style,
                           device="cuda", rollout_weights="float32")
    with open(requests, newline="") as f:
        reqs = cli._requests(list(csv.DictReader(f)), style)
    generate_batch(pipe, reqs, tmp_path / "batched_fp32")
    for r in reqs:
        generate_gesture(r.audio, r.styles, None, None, tmp_path / "single_fp32",
                         style_encoding_type=style, file_name=r.file_name,
                         temperature=r.temperature, seed=r.seed, first_pose=r.first_pose,
                         pipeline=pipe)
        maes = _bvh_mae(tmp_path / "single_fp32" / f"{r.file_name}.bvh",
                        tmp_path / "batched_fp32" / f"{r.file_name}.bvh")
        assert max(maes) < 1e-3, (r.file_name, maes)


def test_a_request_on_the_card_matches_the_cpu(small_models):
    """The 4 s request at temperature 0 through `GesturePipeline.rollout` on
    the card (fp32 rollout weights: one decoder launch) and on the CPU:
    trajectories within the pose MAE budget of 1e-3."""
    from zeggs_tpu_torch.infer import GesturePipeline

    m = small_models

    def trajectories(device):
        pipe = GesturePipeline(m["root"] / "npz", m["data"], options=m["opts"], device=device,
                               rollout_weights="float32")
        with torch.inference_mode():
            feats, n = pipe.audio_to_features(m["root"] / "clip_04s.wav")
            speech = pipe.encode_speech(feats)
            vec, f0 = pipe.style_example_from_bvh(m["root"] / "style.bvh")
            style = pipe.encode_style(vec, 0.0)[0][:, None].expand(-1, n, -1).contiguous()
            out = pipe.rollout(f0, f0.gaze_pos[0].expand(n, 3)[None], speech, style)
        return [o.float().cpu() for o in out]

    cpu = trajectories("cpu")
    before = _launches("decoder_rollout")
    card = trajectories("cuda")
    assert _launches("decoder_rollout") == before + 1
    assert max((a - b).abs().mean().item() for a, b in zip(card, cpu)) < 1e-3


@pytest.mark.parametrize("style", ["example", "label"])
def test_a_streaming_session_on_the_card(small_models, tmp_path, style):
    """The 10 s clip in 0.5 s pushes through a session at quantum 16 on the
    card (fp32 rollout weights; loudness normalisation off, since a stream
    takes a fixed gain): 600 frames, 608 decoder steps (the tail padded to
    the grain), a GRU-cell launch a step and one a program captured, no
    decoder launch, the mel kernel launched, every frame finite. Styled by
    the style BVH, the session's BVH is the offline request's within 1e-4
    cm and 1e-3 degrees (tests/test_streaming.py's bounds)."""
    import dataclasses

    from zeggs_tpu_torch.infer import GesturePipeline, generate_gesture
    from zeggs_tpu_torch.io import bvh, wav

    m = small_models
    label = style == "label"
    pipe = GesturePipeline(m["root"] / ("label" if label else "npz"), m["data"],
                           options=m["opts"], style_encoding_type=style, device="cuda",
                           rollout_weights="float32")
    pipe.mel_cfg = dataclasses.replace(pipe.mel_cfg, normalize_loudness=False)
    styles = ["B"] if label else [(m["root"] / "style.bvh", None)]
    first_pose = m["root"] / "style.bvh" if label else None
    generate_gesture(m["root"] / "clip_10s.wav", styles, None, None, tmp_path,
                     style_encoding_type=style, first_pose=first_pose, file_name="offline",
                     seed=7, pipeline=pipe)
    _, audio = wav.read_wavfile(m["root"] / "clip_10s.wav", rescale=True, desired_fs=16000,
                                out_type="float32")
    audio = np.asarray(audio, np.float32)
    made, before = len(pipe.programs.programs()), build.launches()
    sess = pipe.streaming_session(styles, first_pose=first_pose, seed=7, quantum=16)
    for o in range(0, len(audio), 8000):
        sess.push(audio[o : o + 8000])
    sess.finish()
    torch.cuda.synchronize()
    launched = build.launches_since(before)
    made = len(pipe.programs.programs()) - made
    assert sess.frames_emitted == 600 and sess.decoder_steps == -(-599 // 16) * 16 and made >= 1
    assert launched["gru_cell"] == sess.decoder_steps + made
    assert launched["decoder_step"] == 4 * launched["gru_cell"]
    assert launched["decoder_rollout"] == 0 and launched["mel_spectrogram"] > 0
    path = sess.write_bvh(tmp_path, "stream")
    assert np.isfinite(bvh.load(path)["rotations"]).all()
    if not label:
        pos, rot = _bvh_mae(tmp_path / "offline.bvh", path)
        assert pos < 1e-4 and rot < 1e-3, (pos, rot)


def _post(port, path, payload):
    import json
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _frames(f):
    import base64

    return {k: np.frombuffer(base64.b64decode(v["b64"]), np.float32).reshape(v["shape"])
            for k, v in f["data"].items()}


@pytest.mark.parametrize("replicas", [1, 2])
def test_the_daemon_on_the_card(small_models, tmp_path, replicas):
    """The daemon on 127.0.0.1 over the card, or over a mesh of two replicas
    on cuda:0 (each run's programs captured first by `warmup`), at fp32
    rollout weights: /healthz names the card; four concurrent /synthesize of
    CLIPS coalesce into one batch of four (the drain ends at the fourth),
    one mel launch a request, each BVH within the pose MAE budget of 1e-3
    of `generate_batch` without a mesh. Over one replica, a stream over
    HTTP (the 4 s clip in five pushes, to a daemon that waits 50 ms for a
    drain) equals the in-process session within 1e-5."""
    import base64
    import json
    import threading
    import urllib.request

    from zeggs_tpu_torch.infer import GesturePipeline
    from zeggs_tpu_torch.infer.batch import Request, generate_batch, warmup
    from zeggs_tpu_torch.io import wav
    from zeggs_tpu_torch.parallel import create_mesh
    from zeggs_tpu_torch.serve import GestureServer

    m = small_models
    pipe = GesturePipeline(m["root"] / "npz", m["data"], options=m["opts"], device="cuda",
                           rollout_weights="float32")
    mesh = create_mesh(devices=["cuda:0"] * 2) if replicas > 1 else None
    clips = [list(CLIPS)[i % len(CLIPS)] for i in range(4)]
    reqs = [Request(audio=m["root"] / f"{clip}.wav", styles=[(m["root"] / "style.bvh", None)],
                    file_name=f"serve_{i}", seed=50 + i) for i, clip in enumerate(clips)]
    if mesh is not None:
        warmup(pipe, [round(60 * CLIPS[clip]) for clip in clips], max_batch=4, mesh=mesh)
    generate_batch(pipe, reqs, tmp_path / "plain")
    style = base64.b64encode((m["root"] / "style.bvh").read_bytes()).decode()
    replies = [None] * 4

    def request(i):
        replies[i] = _post(port, "/synthesize", {
            "audio_wav_b64": base64.b64encode(reqs[i].audio.read_bytes()).decode(),
            "styles": [{"bvh_b64": style}], "seed": reqs[i].seed,
            "file_name": reqs[i].file_name})

    srv = GestureServer(pipe, max_batch=4, max_wait_ms=60_000, mesh=mesh)
    port = srv.start()
    try:
        health = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                                   timeout=60).read())
        assert health.get("platform") == "cuda", health
        assert health.get("device") == torch.cuda.get_device_name(0), health
        before = build.launches()
        threads = [threading.Thread(target=request, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads) and None not in replies
        assert build.launches_since(before)["mel_spectrogram"] == 4
    finally:
        srv.stop()
    assert [r["batch_size"] for r in replies] == [4] * 4
    for r in replies:
        (tmp_path / f"{r['file_name']}.bvh").write_text(r["bvh"])
        maes = _bvh_mae(tmp_path / "plain" / f"{r['file_name']}.bvh",
                        tmp_path / f"{r['file_name']}.bvh")
        assert max(maes) < 1e-3, (r["file_name"], maes)
    if mesh is not None:
        return

    _, audio = wav.read_wavfile(m["root"] / "clip_04s.wav", rescale=True, desired_fs=16000,
                                out_type="float32")
    parts = np.array_split(np.asarray(audio, np.float32), 5)
    srv = GestureServer(pipe, max_batch=4, max_wait_ms=50)
    port = srv.start()
    try:
        start = _post(port, "/stream/start", {"styles": [{"bvh_b64": style}], "seed": 7})
        chunks = [_frames(start["frames"])]
        for part in parts:
            chunks.append(_frames(_post(port, "/stream/push", {
                "session_id": start["session_id"],
                "audio_f32_b64": base64.b64encode(part.astype("<f4").tobytes()).decode(),
            })["frames"]))
        fin = _post(port, "/stream/finish", {"session_id": start["session_id"]})
        chunks.append(_frames(fin["frames"]))
    finally:
        srv.stop()
    sess = pipe.streaming_session([(m["root"] / "style.bvh", None)], seed=7, quantum=16)
    direct = [sess._collect(0)] + [sess.push(p) for p in parts] + [sess.finish()]
    assert fin["total_frames"] == 240
    for k in direct[0]:
        got, want = (np.concatenate([c[k] for c in cs]) for cs in (chunks, direct))
        assert np.abs(got - want).max() <= 1e-5, k


def _launches_after_last_replay(prof):
    """From a torch.profiler run: the graph launches, and the CUDA runtime
    calls on the host that launch work (kernels, copies, sets) after the
    last graph launch, each with the innermost aten op around it on its
    thread (None: outside any) -> (graph launches, [(call, op), ...])."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    graphs = [e for e in events if "GraphLaunch" in e.name]
    if not graphs:
        return 0, []
    last = max(e.time_range.start for e in graphs)
    ops = [e for e in events if e.name.startswith("aten::")]
    after = []
    for e in events:
        if e.time_range.start <= last or "GraphLaunch" in e.name or not any(
                w in e.name for w in ("Launch", "Memcpy", "Memset")):
            continue
        around = [o for o in ops if o.thread == e.thread
                  and o.time_range.start <= e.time_range.start
                  and o.time_range.end >= e.time_range.end]
        op = max(around, key=lambda o: o.time_range.start).name if around else None
        after.append((e.name, op))
    return len(graphs), after


def test_after_a_chunks_finish_program_only_copies_run(small_models, tmp_path):
    """The 10 and 12 s clips as one chunk (T_pad 1024) at float16 transfer,
    its programs captured by a first run, under torch.profiler: one graph
    launch a grain replay of the 1023 steps, one for the finish program and
    one for the bake program; after the last, the host launches nothing but
    the copies of the outputs (`aten::copy_`)."""
    from zeggs_tpu_torch.infer import GesturePipeline
    from zeggs_tpu_torch.infer.batch import Request, generate_batch
    from zeggs_tpu_torch.infer.programs import ladder

    m = small_models
    pipe = GesturePipeline(m["root"] / "npz", m["data"], options=m["opts"], device="cuda",
                           rollout_weights="float32", transfer_dtype="float16")
    reqs = [Request(audio=m["root"] / f"{clip}.wav", styles=[(m["root"] / "style.bvh", None)],
                    file_name=clip, seed=60 + i)
            for i, clip in enumerate(("clip_10s", "clip_12s"))]
    generate_batch(pipe, reqs, tmp_path / "first")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        generate_batch(pipe, reqs, tmp_path / "profiled")
        torch.cuda.synchronize()
    graphs, after = _launches_after_last_replay(prof)
    assert graphs == sum(reps for _, reps in ladder(1023)) + 2
    assert after and all(op == "aten::copy_" for _, op in after), after


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


def test_the_corpus_pipeline_on_the_card(small_run, monkeypatch):
    """The small run's raw corpus (three clips) through `data_pipeline` on
    the card at the time-stretches 0.9 and 1.0: one mel launch a clip and
    stretch, each against its plain chain on the same input within 2e-4,
    and the processed arrays finite."""
    from zeggs_tpu_torch import config as C
    from zeggs_tpu_torch.data.pipeline import data_pipeline

    root, tts, inputs = small_run["root"], M.mel_spectrogram_tts, []

    def recording(x, cfg, fused=None):
        inputs.append((x, cfg))
        return tts(x, cfg, fused)

    monkeypatch.setattr(M, "mel_spectrogram_tts", recording)
    before = build.launches()
    data_pipeline(C.PipelineConfig(
        base_path=str(root), processed_data_path="processed_card", info_filename="info.csv",
        len_ratios=(0.9, 1.0), save_trimmed_audio=False, save_trimmed_animation=False),
        device="cuda")
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert build.launches_since(before) == _counts(mel_spectrogram=3 * 2)
    assert len(inputs) == 3 * 2
    with torch.inference_mode():
        for x, cfg in inputs:
            out, ref = tts(x, cfg), tts(x, cfg, False)
            assert out.shape == ref.shape and torch.isfinite(out).all()
            assert (out - ref).abs().max().item() <= 2e-4
    with np.load(root / "processed_card" / "processed_data.npz") as data:
        for k in data.files:
            if data[k].dtype.kind == "f":
                assert np.isfinite(data[k]).all(), k


def test_evaluate_on_the_card_matches_the_cpu(small_run, monkeypatch):
    """`cli.eval_checkpoint.evaluate` on the card against the CPU: its
    rollouts replay the rollout programs, one GRU-cell launch a decoder
    step of the validation rollouts and one a program's capture; the
    tolerances of tests/test_torch_quality.py (`tests/eval_agreement.py`:
    rtol 1e-3 and a rounding quantum; the jerk and variance ratios within
    the bounds derived from the two rollouts' difference); equal gate
    verdicts."""
    # by module name from tests/, which pytest puts on sys.path: a `tests`
    # package installed on the card's machine shadows the repository's
    from eval_agreement import eval_bounds, reports_agree
    from zeggs_tpu_torch.cli import eval_checkpoint as E
    from zeggs_tpu_torch.infer.programs import ProgramCache, ladder_programs

    rollouts = {"cuda": [], "cpu": []}
    original = ProgramCache.rollout

    def recording(*args, **kw):
        out = original(*args, **kw)  # root_pos, root_rot, lpos, ltxy
        rollouts[out[1].device.type].append(tuple(out[i][0].cpu().numpy() for i in (0, 2)))
        return out

    monkeypatch.setattr(ProgramCache, "rollout", recording)
    root, ds = small_run["root"], small_run["ds"]
    before = build.launches()
    card = E.evaluate(root, 0, device="cuda")
    torch.cuda.synchronize()
    launched = build.launches_since(before)
    cpu = E.evaluate(root, 0, device="cpu")
    steps = [len(r[1]) - 1 for r in rollouts["cuda"]]
    # every decoder step replayed, and one eager warm-up step a program
    n = sum(steps) + ladder_programs(steps)
    assert launched == _counts(gru_cell=n, decoder_step=4 * n)
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
    before = _launches("gru_cell")
    steps, programs = trainer.generate_samples(1, 2)
    torch.cuda.synchronize()
    assert _launches("gru_cell") - before == steps + programs and programs > 0
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


@pytest.mark.parametrize("host_batches", [False, True])
def test_two_processes_sharing_the_card_equal_one_process(small_run, tmp_path, host_batches):
    """Two processes of a gloo group on the card (the training CLI with the
    three multi-process flags, tests/torch_ddp_worker.py), each replaying
    graphs A (gather, forward, backward) and B (RAdam) around the eager
    all-reduce, against one process (one graph) at the same seed: B=8,
    window 32, 3 steps, on both data paths. Parameters within rtol 2e-5 /
    atol 1e-6 (tests/test_torch_ddp.py's bound), equal generator states."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from zeggs_tpu_torch.cli import train as cli
    from zeggs_tpu_torch.io import checkpoint

    def options(name):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps({
            "net_opt": {"decoder": {"nhidden": 64},
                        "speech_encoder": {"nhidden": 16, "speech_encoding_size": 16},
                        "style_encoder": {"nhidden": 24, "style_encoding_size": 8,
                                          "example_length": 32}},
            "train_opt": {"batchsize": 8, "window": 32, "niterations": 1, "seed": 77,
                          "generate_samples_step": 10_000, "use_tensorboard": False},
            "paths": {"base_path": str(small_run["root"]), "path_processed_data": "processed",
                      "output_dir": str(tmp_path / name), "models_dir": None}}))
        return path

    host = ["--host-batches"] if host_batches else []
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    worker = Path(__file__).parent / "torch_ddp_worker.py"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    # host batches: each rank its own directory (rank 0 writes)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), f"127.0.0.1:{port}", "2", str(rank),
         str(options(f"multi{rank if host_batches else 0}")), "3", str(int(host_batches)),
         "--device", "cuda", "--dist-backend", "gloo"],
        cwd=worker.parents[1], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in (0, 1)]
    try:
        outputs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {rank}:\n{out[-4000:]}"
    one = cli.main(["-o", str(options("single")), "--device", "cuda", "--max-iterations", "3",
                    *host])
    assert len(one.program.graphs) == 1
    multi, _, m_meta = checkpoint.load_train_state(tmp_path / "multi0" / "saved_models")
    single, _, s_meta = checkpoint.load_train_state(tmp_path / "single" / "saved_models")
    assert m_meta["step"] == s_meta["step"] == 3
    assert m_meta["np_rng_state"] == s_meta["np_rng_state"]
    assert m_meta["torch_generator_state"] == s_meta["torch_generator_state"]
    flat_m, flat_s = checkpoint._flatten(multi), checkpoint._flatten(single)
    assert flat_m.keys() == flat_s.keys()
    for k, a in flat_m.items():
        np.testing.assert_allclose(a, flat_s[k], rtol=2e-5, atol=1e-6, err_msg=k)


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


def _motion75(nframes, seed):
    """A 75-joint BVH dict (the featurizer's spine names, then a bushy tree)
    of sinusoidal joint rotations and a root walking along x."""
    rng = np.random.default_rng(seed)
    names = ["Hips", "Spine", "Spine1", "Spine2", "Spine3", "Neck", "Head"]
    names += [f"Joint{i}" for i in range(len(names), 75)]
    parents = [-1] + [i - 1 if i < 7 else (i - 1) % 7 for i in range(1, 75)]
    t = np.linspace(0, 2 * np.pi, nframes)[:, None, None]
    rotations = rng.uniform(3, 20, (1, 75, 3)) * np.sin(2 * t + rng.uniform(0, 6.3, (1, 75, 3)))
    positions = np.repeat(rng.uniform(-8, 8, (1, 75, 3)), nframes, axis=0)
    positions[:, 0] = [0.0, 95.0, 0.0]
    positions[:, 0, 0] += np.linspace(0, 20, nframes)
    return {"rotations": rotations.astype(np.float32), "positions": positions.astype(np.float32),
            "parents": np.asarray(parents, np.int32), "names": names, "order": "zyx",
            "frametime": 1.0 / 60.0}


def test_batched_first_poses_on_the_card_equal_each_clip_alone(device):
    """A job's first poses (75 joints; 20 clips of 64 frames and 3 of 80) in
    one pass a frame count equal each clip featurized alone on the card."""
    from zeggs_tpu_torch.data import features as F

    anims = [_motion75(64 if i < 20 else 80, i) for i in range(23)]
    batched = F.preprocess_animations(anims, device=device)
    for anim, ours in zip(anims, batched):
        alone = F.preprocess_animation(anim, device=device)
        for name, a in vars(alone).items():
            assert torch.equal(a, getattr(ours, name)), name


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
