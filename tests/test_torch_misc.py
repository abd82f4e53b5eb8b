"""The port's mel helpers and Griffin-Lim, BVH retargeting (`change_bvh`),
loggers and profiling helpers, against zeggs_tpu's on the same seeded
inputs (the counterparts of tests/test_misc.py).

Tolerances: the STFT magnitude and the mel inversion atol 1e-6 (readings
1.5e-8 on magnitudes up to 0.07); Griffin-Lim, 30 iterations from JAX's own
first signal on a mel-inverted magnitude, a relative L2 error of 1e-4
(readings 3.6e-6 to 8.9e-6 over 1 s and 3 s clips and two first signals:
pocketfft against XLA's FFT, compounded over the iterations; the largest
single-sample error grows with the length, to 3.9e-5 of the peak at 3 s);
`change_bvh` outputs: positions 1e-4 cm, rotations compared as matrices
1e-5 (Euler angles wrap).
"""

import json
import logging
import queue

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zeggs_tpu.ops import mel as jm
from zeggs_tpu.utils import change_bvh as jax_change_bvh
from zeggs_tpu.utils import logs as jax_logs
from zeggs_tpu_torch.io import bvh
from zeggs_tpu_torch.ops import mel as tm
from zeggs_tpu_torch.ops import xform
from zeggs_tpu_torch.utils import change_bvh, logs, profiling
from tests.synthetic import make_motion

FS, N_FFT, HOP = 16000, 800, 200
GL_TOL = 1e-4  # relative L2 error of Griffin-Lim's signal


def _speechy(seconds=0.5, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * FS)) / FS
    x = sum(np.sin(2 * np.pi * f * t) / k for k, f in enumerate((180, 360, 540, 1100), 1))
    return (0.3 * x + 0.01 * rng.normal(size=t.shape)).astype(np.float32)


@pytest.mark.parametrize("centered", [True, False])
@pytest.mark.parametrize("real_amplitude", [True, False])
def test_stft_magnitude_matches_jax(centered, real_amplitude):
    x, w = _speechy(), tm.hann_symmetric(N_FFT)
    ref = np.asarray(jm.stft_magnitude(jnp.asarray(x), jnp.asarray(w), N_FFT, HOP,
                                       real_amplitude=real_amplitude, centered=centered))
    ours = tm.stft_magnitude(torch.as_tensor(x), torch.as_tensor(w), N_FFT, HOP,
                             real_amplitude=real_amplitude, centered=centered).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-6 * (1 if real_amplitude else N_FFT), rtol=0)


def test_mel_helpers_match_jax():
    for args in ((50, N_FFT, HOP, True), (50, N_FFT, HOP, False), (1, 1024, 256, True)):
        assert tm.num_wav_samples(*args) == jm.num_wav_samples(*args)
    rng = np.random.default_rng(1)
    mel = rng.uniform(0, 1, (80, 30)).astype(np.float32)
    np.testing.assert_array_equal(
        tm.pre_emphasis_on_mel(mel, 0.97, FS, 80, 20, 7600, min_amplitude=1e-5),
        jm.pre_emphasis_on_mel(mel, 0.97, FS, 80, 20, 7600, min_amplitude=1e-5))
    db = rng.uniform(-60, 10, (30, 80)).astype(np.float32)
    np.testing.assert_allclose(tm.db_to_amplitude(torch.as_tensor(db)).numpy(),
                               np.asarray(jm.db_to_amplitude(jnp.asarray(db))), rtol=1e-6)
    norm = rng.uniform(0, 1, (30, 80)).astype(np.float32)
    np.testing.assert_allclose(tm.denormalize_range(torch.as_tensor(norm), 1e-5 / N_FFT).numpy(),
                               np.asarray(jm.denormalize_range(jnp.asarray(norm), 1e-5 / N_FFT)),
                               atol=1e-5, rtol=0)
    amp = rng.uniform(0, 1, (30, 80)).astype(np.float32)
    for normalize in (False, True):
        ours = tm.mel_to_linear(torch.as_tensor(amp), FS, N_FFT, 20, 7600, normalize).numpy()
        ref = np.asarray(jm.mel_to_linear(jnp.asarray(amp), FS, N_FFT, 20, 7600, normalize))
        assert ours.shape == ref.shape == (30, N_FFT // 2 + 1)
        np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_db_roundtrip():
    x = tm.db_to_amplitude(torch.tensor([-20.0, 0.0, 6.0])).numpy()
    np.testing.assert_allclose(x, [0.1, 1.0, 10**0.3], atol=1e-5)
    denorm = tm.denormalize_range(torch.tensor([0.0, 0.5, 1.0]), 1e-5).numpy()
    np.testing.assert_allclose(denorm, [-100.0, -50.0, 0.0], atol=1e-4)


def _mel_magnitude():
    """The linear magnitude Griffin-Lim sees in use: a mel spectrogram,
    undone to amplitudes and inverted through the filterbank."""
    cfg = tm.MelConfig()
    mel_db = tm.mel_spectrogram_tts(torch.as_tensor(_speechy(1.0)), cfg, fused=False)
    amp = tm.db_to_amplitude(tm.denormalize_range(mel_db, cfg.min_clipping / cfg.filter_length))
    return tm.mel_to_linear(amp, FS, N_FFT, cfg.mel_fmin, cfg.mel_fmax).numpy()


def test_griffin_lim_matches_jax_from_its_first_signal():
    mag = _mel_magnitude()
    n = int(mag.shape[0] * HOP + N_FFT)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float32))
    ref = np.asarray(jm.griffin_lim(mag, HOP, N_FFT, iterations=30, seed=0))
    ours = tm.griffin_lim(torch.as_tensor(mag), HOP, N_FFT, iterations=30, signal=noise).numpy()
    assert ours.shape == ref.shape
    err = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
    assert err < GL_TOL, err


def test_griffin_lim_first_signal_from_the_generator():
    mag = torch.as_tensor(_mel_magnitude()[:8])
    a = tm.griffin_lim(mag, HOP, iterations=2, generator=torch.Generator().manual_seed(3))
    b = tm.griffin_lim(mag, HOP, iterations=2, generator=torch.Generator().manual_seed(3))
    c = tm.griffin_lim(mag, HOP, iterations=2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(c, tm.griffin_lim(mag, HOP, iterations=2,
                                         generator=torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="samples"):
        tm.griffin_lim(mag, HOP, iterations=1, signal=torch.zeros(10))


def test_griffin_lim_recovers_tone():
    """Griffin-Lim on the magnitude of a pure tone gives a signal whose
    spectrum peaks at the tone's frequency."""
    t = np.arange(FS) / FS
    x = torch.as_tensor((0.5 * np.sin(2 * np.pi * 500 * t)).astype(np.float32))
    mag = tm.stft_magnitude(x, torch.as_tensor(tm.hann_symmetric(N_FFT)), N_FFT, HOP,
                            real_amplitude=False, centered=False)
    y = tm.griffin_lim(mag, HOP, N_FFT, iterations=20).numpy()
    assert np.isfinite(y).all()
    spec = np.abs(np.fft.rfft(y))
    freq = np.fft.rfftfreq(len(y), 1 / FS)
    assert abs(freq[np.argmax(spec)] - 500) < 10


@pytest.mark.parametrize("kwargs", [dict(fps=30, center=True), dict(order="xzy"),
                                    dict(pace=0.8), dict(fps=120)])
def test_change_bvh_matches_jax(tmp_path, kwargs):
    src = tmp_path / "a.bvh"
    bvh.save(src, make_motion(60))
    change_bvh(str(src), str(tmp_path / "port.bvh"), **kwargs)
    jax_change_bvh(str(src), str(tmp_path / "jax.bvh"), **kwargs)
    ours, ref = bvh.load(tmp_path / "port.bvh"), bvh.load(tmp_path / "jax.bvh")
    assert ours["order"] == ref["order"] and ours["frametime"] == ref["frametime"]
    assert ours["rotations"].shape == ref["rotations"].shape
    np.testing.assert_allclose(ours["positions"], ref["positions"], atol=1e-4, rtol=0)

    def mats(anim):
        return xform.from_euler(torch.as_tensor(np.radians(anim["rotations"].astype(np.float64))),
                                anim["order"]).numpy()

    np.testing.assert_allclose(mats(ours), mats(ref), atol=1e-5, rtol=0)
    if kwargs.get("center"):
        # the root starts at x = z = 0
        assert abs(ours["positions"][0, 0, 0]) < 1e-3 and abs(ours["positions"][0, 0, 2]) < 1e-3
    if kwargs.get("fps"):
        assert abs(ours["frametime"] - 1 / kwargs["fps"]) < 1e-6


def test_loggers(tmp_path, capsys):
    assert logs.get_logger_from_arg(None) is logging.getLogger("zeggs_tpu_torch")
    named = logging.getLogger("already")
    assert logs.get_logger_from_arg(named) is named
    log = logs.get_logger("port_filelog", log_file=tmp_path / "x.log", console=False)
    assert logs.get_logger("port_filelog", log_file=tmp_path / "x.log", console=False) is log
    assert len(log.handlers) == 1
    log.warning("to file")
    for h in log.handlers:
        h.flush()
    assert "[WARNING] port_filelog: to file" in (tmp_path / "x.log").read_text()

    printer = logs.ConsolePrintLogger()
    printer.info("plain")
    printer.warning("careful")
    printer.error("broken")
    out = capsys.readouterr()
    assert out.out == "plain\nWARNING: careful\n" and out.err == "ERROR: broken\n"


def test_queue_logger_drains_as_jax(tmp_path):
    """Both packages' proxies queue the same records and drain them into
    the same log lines."""
    lines = []
    for pkg, name in ((logs, "port_drain"), (jax_logs, "jax_drain")):
        proxy = pkg.QueueLogger(queue.Queue())
        proxy.info("from worker")
        proxy.warning("careful")
        proxy.debug("dropped at INFO")
        target = pkg.get_logger(name, log_file=tmp_path / f"{name}.log", console=False)
        proxy.drain(target)
        for h in target.handlers:
            h.flush()
        text = (tmp_path / f"{name}.log").read_text().splitlines()
        lines.append([line.split(" [", 1)[1].replace(name, "<name>") for line in text])
    assert lines[0] == lines[1] == ["INFO] <name>: from worker", "WARNING] <name>: careful"]


def test_profiling_helpers(tmp_path):
    assert profiling.device_memory_stats() == (
        {"cpu": None} if not torch.cuda.is_available()
        else {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())})
    calls = []
    stats = profiling.time_fn(lambda n: calls.append(n), 7, iters=5, warmup=2)
    assert calls == [7] * 7 and len(stats["times"]) == 5
    assert stats["p10_s"] <= stats["median_s"] <= stats["p90_s"]
    with profiling.trace(tmp_path / "trace") as prof:
        with profiling.annotate("port_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "port_region" for e in prof.key_averages())
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "port_region" for e in events)
