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
        "'bench.train', 'bench.__main__'}\n"
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
