"""The port's own host IO (`zeggs_tpu_torch.io.{bvh, wav, checkpoint}` and
`zeggs_tpu_torch.audio.loudness`) against the JAX package's modules on the
same synthetic files and arrays: loads are equal, written BVH text is
identical, `.npz` checkpoints and WAV files cross-read both ways. And the
port, with `chip_smoke.py`, imports neither `zeggs_tpu` nor `jax`.

Everything here is exact: the modules are copies, so any difference is a
fault, not rounding.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from zeggs_tpu.audio import loudness as jax_loudness
from zeggs_tpu.io import bvh as jax_bvh
from zeggs_tpu.io import checkpoint as jax_checkpoint
from zeggs_tpu.io import wav as jax_wav
from zeggs_tpu_torch.audio import loudness
from zeggs_tpu_torch.io import bvh, checkpoint, native, wav
from zeggs_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]


def _anim(seed=0, njoints=7, nframes=40):
    rng = np.random.default_rng(seed)
    parents = np.asarray([-1, 0, 1, 2, 1, 4, 0], np.int32)[:njoints]
    offsets = rng.uniform(-10, 10, (njoints, 3)).astype(np.float32)
    pos = np.repeat(offsets[None], nframes, axis=0)
    pos[:, 0] += rng.normal(size=(nframes, 3)).astype(np.float32) * 5
    return {"rotations": rng.uniform(-90, 90, (nframes, njoints, 3)).astype(np.float32),
            "positions": pos.astype(np.float32), "offsets": offsets, "parents": parents,
            "names": [f"J{i}" for i in range(njoints)], "order": "zyx", "frametime": 1 / 60}


def _assert_anim_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("translations", [False, True])
def test_bvh_written_text_is_identical_and_loads_agree(tmp_path, translations):
    anim = _anim(seed=int(translations))
    bvh.save(tmp_path / "port.bvh", anim, translations=translations)
    jax_bvh.save(tmp_path / "jax.bvh", anim, translations=translations)
    assert (tmp_path / "port.bvh").read_text() == (tmp_path / "jax.bvh").read_text()
    for path in (tmp_path / "port.bvh", tmp_path / "jax.bvh"):
        _assert_anim_equal(bvh.load(path), jax_bvh.load(path))
    _assert_anim_equal(bvh.load(tmp_path / "port.bvh", start=3, end=20),
                       jax_bvh.load(tmp_path / "port.bvh", start=3, end=20))


def test_bvh_numpy_path_equals_native_path(tmp_path, monkeypatch):
    """Without the C++ parser the port keeps the numpy path, and both give
    the same animation and the same text."""
    anim = _anim(seed=2)
    bvh.save(tmp_path / "native.bvh", anim)
    loaded = bvh.load(tmp_path / "native.bvh")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    bvh.save(tmp_path / "numpy.bvh", anim)
    assert (tmp_path / "native.bvh").read_text() == (tmp_path / "numpy.bvh").read_text()
    _assert_anim_equal(bvh.load(tmp_path / "numpy.bvh"), loaded)


def test_native_parser_builds_into_the_build_directory():
    if not native.available():
        pytest.skip("no host C++ compiler")
    assert native.parse_float_matrix("1 2 3\n4 5 6\n").tolist() == [[1, 2, 3], [4, 5, 6]]
    assert list(native._BUILD_DIR.glob("libfastparse_*.so"))


def _need_native():
    if not native.available():
        pytest.skip("no host C++ compiler")


def _edge_values():
    """Values where integer-digit '%f' could part from snprintf's: signed
    zeros and tiny negatives, sixth-decimal ties (odd multiples of 2^-7),
    both sides of the 9e12 fast-path limit, the extremes, the wide values
    snprintf once truncated, NaN of either sign and the infinities."""
    f32 = np.finfo(np.float32)
    ties = np.arange(1, 256, 2, dtype=np.float32) / 128
    limit = np.float32(9e12)
    below = [np.nextafter(limit, np.float32(0))]
    above = [limit]
    for _ in range(2):
        below.append(np.nextafter(below[-1], np.float32(0)))
        above.append(np.nextafter(above[-1], np.float32(np.inf)))
    with np.errstate(invalid="ignore"):
        computed_nan = np.float32(0) / np.float32(0)  # the sign bit set, on x86
    special = np.array([0.0, -0.0, 1e-9, -1e-9, 4e-7, 5e-7, -5e-7, f32.tiny, -f32.tiny,
                        f32.smallest_subnormal, f32.max, -f32.max, 1e24, -1e24, -3e38,
                        np.nan, -np.nan, computed_nan, np.inf, -np.inf], np.float32)
    return np.concatenate([ties, -ties, ties + 1000, 65535 + ties[:9], below, above,
                           np.negative(above), special]).astype(np.float32)


def _assert_same_text(got, want):
    if got != want:
        rows = list(zip(got.splitlines(), want.splitlines()))
        first = next((i for i, (a, b) in enumerate(rows) if a != b), len(rows))
        pytest.fail(f"{len(got)} / {len(want)} bytes; first differing row {first}: "
                    f"{rows[first] if first < len(rows) else 'past the end'}")


@pytest.mark.parametrize("draw", ["finite_bit_patterns", "uniform_360"])
def test_native_formatter_equals_percent_f(draw):
    """The integer-digit formatter writes what Python's '%f' writes, byte for
    byte, over a million float32 values."""
    _need_native()
    rng = np.random.default_rng(20)
    if draw == "finite_bit_patterns":
        v = rng.integers(0, 2**32, 1_100_000, dtype=np.uint64).astype(np.uint32).view(np.float32)
        v = v[np.isfinite(v)][:1_000_000]
    else:
        v = rng.uniform(-360, 360, 1_000_000).astype(np.float32)
    m = v.reshape(-1, 8)
    _assert_same_text(bytes(native.format_float_matrix(m)), bvh._motion_text(m))


def test_native_formatter_edge_values():
    _need_native()
    m = _edge_values().reshape(1, -1)
    got = bytes(native.format_float_matrix(m))
    _assert_same_text(got, bvh._motion_text(m))
    assert b"\0" not in got
    assert got.split()[-5:] == [b"nan", b"nan", b"nan", b"inf", b"-inf"]
    for v, text in ((-0.0, b"-0.000000"), (-1e-9, b"-0.000000"), (2**-7, b"0.007812"),
                    (3 * 2**-7, b"0.023438"), (5e-7, b"0.000000"), (-3e38,
                    b"-300000000549775575777803994281145270272.000000")):
        assert bytes(native.format_float_matrix(np.float32([[v]]))) == text + b"\n", v


def test_bvh_save_edge_values_same_file_with_and_without_the_native_formatter(
        tmp_path, monkeypatch):
    _need_native()
    anim = _anim(seed=4)
    edges = _edge_values()
    anim["rotations"].reshape(-1)[:len(edges)] = edges
    anim["positions"][:, 0].reshape(-1)[:9] = edges[-9:]
    bvh.save(tmp_path / "native.bvh", anim)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    bvh.save(tmp_path / "numpy.bvh", anim)
    _assert_same_text((tmp_path / "native.bvh").read_bytes(),
                      (tmp_path / "numpy.bvh").read_bytes())


def test_native_formatter_counts_values_and_fallbacks(tmp_path):
    _need_native()

    def counted(run):
        before = profiling.counters()
        run()
        after = profiling.counters()
        return tuple(after.get(k, 0) - before.get(k, 0)
                     for k in ("bvh.values_formatted", "bvh.values_fallback"))

    m = np.float32([[1.5, np.nan, -np.inf], [9e12, 1e24, -0.0]])  # float32(9e12) > 9e12
    assert counted(lambda: native.format_float_matrix(m)) == (6, 4)
    anim = _anim(seed=5, nframes=30)
    assert counted(lambda: bvh.save(tmp_path / "a.bvh", anim)) == (30 * (3 + 7 * 3), 0)


def test_checkpoints_cross_read_both_ways(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"enc": {"w": rng.normal(size=(4, 3)).astype(np.float32), "b": np.zeros(3)},
            "layers": [{"w": rng.normal(size=(2, 2))}, {"w": np.arange(5, dtype=np.int32)}]}
    meta = {"step": 7, "note": "x"}
    checkpoint.save(tmp_path / "port.npz", tree, meta)
    jax_checkpoint.save(tmp_path / "jax.npz", tree, meta)
    for path in (tmp_path / "port.npz", tmp_path / "jax.npz"):
        (a, ma), (b, mb) = checkpoint.load(path), jax_checkpoint.load(path)
        assert ma == mb == meta
        assert a["layers"][1]["w"].dtype == np.int32 and len(a["layers"]) == 2
        for x, y in ((a["enc"]["w"], b["enc"]["w"]), (a["enc"]["b"], b["enc"]["b"]),
                     (a["layers"][0]["w"], tree["layers"][0]["w"]),
                     (a["layers"][1]["w"], b["layers"][1]["w"])):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fs", [16000, 22050])
def test_wav_cross_read_and_resample(tmp_path, fs):
    rng = np.random.default_rng(fs)
    x = (0.5 * rng.uniform(-1, 1, fs // 2)).astype(np.float32)
    wav.write_wavefile(tmp_path / "port.wav", x, fs)
    jax_wav.write_wavefile(tmp_path / "jax.wav", x, fs)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    a = wav.read_wavfile(tmp_path / "port.wav", desired_fs=16000)
    b = jax_wav.read_wavfile(tmp_path / "port.wav", desired_fs=16000)
    assert a[0] == b[0] == 16000
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(wav.trim_silence(a[1], 16000), jax_wav.trim_silence(b[1], 16000))


def test_loudness_matches():
    rng = np.random.default_rng(5)
    x = (0.1 * rng.normal(size=16000)).astype(np.float32)
    assert loudness.integrated_loudness(x, 16000) == jax_loudness.integrated_loudness(x, 16000)
    np.testing.assert_array_equal(loudness.normalize_loudness(x, 16000, -20.0),
                                  jax_loudness.normalize_loudness(x, 16000, -20.0))


def test_port_and_chip_smoke_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None; sys.modules['zeggs_tpu'] = None\n"
        "sys.modules['__graft_entry__'] = None\n"
        "import zeggs_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(zeggs_tpu_torch.__path__, "
        "'zeggs_tpu_torch.')]\n"
        "assert len(names) > 40, names\n"
        "new = {'train.loop', 'train.loss', 'train.radam', 'data.pipeline', 'data.dataset', "
        "'data.device_dataset', 'cli.train', 'cli.pipeline', 'utils.metrics', 'utils.logs', "
        "'io.torch_compat', 'cli.convert', 'cli.compare', 'cli.bvh2fbx', 'parallel', "
        "'parallel.distributed', 'utils.profiling', 'cli.eval_checkpoint', 'parallel.mesh', "
        "'bench', 'bench.fixture', 'bench.core', 'bench.serve', 'bench.streaming', "
        "'bench.train', 'bench.__main__', 'data.synthetic', 'cli.train_curve', "
        "'cli.train_anneal', 'profilers', 'profilers.common', 'profilers.fused_b1_profile', "
        "'profilers.loss_profile', 'profilers.grad_profile', 'profilers.train_step_profile', "
        "'profilers.train_roofline', 'examples', 'examples.quickstart'}\n"
        "assert {'zeggs_tpu_torch.' + n for n in new} <= set(names), names\n"
        "for n in names + ['chip_smoke']:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m.split('.')[0] in ('jax', 'zeggs_tpu', '__graft_entry__'))]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
