"""The port's corpus pipeline on the CPU against zeggs_tpu's, on the same raw
corpus (tests/synthetic.py: 3 clips of 4 s, 8 joints, the last one
validation; len_ratios 0.9 and 1.0).

Budgets: ranges, labels, data_definition.json, the summary and
data_info.html equal;
animation features within 1e-5 (velocities as displacements, v * dt:
finite differences amplify a one-ulp position difference by 1/dt = 60);
audio features within 2e-4, the mel budget; statistics within 1e-4
relative (to each element, or to the statistic's largest magnitude for
elements near zero). A sharded run, merged, equals the serial run bit for bit. The
config files read to the JAX package's values.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zeggs_tpu import config as JC
from zeggs_tpu.data import pipeline as jpipe
from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.cli import pipeline as cli
from zeggs_tpu_torch.data import pipeline as tpipe
from zeggs_tpu_torch.io import bvh as tbvh
from zeggs_tpu_torch.ops import xform
from tests.synthetic import write_raw_corpus

REPO = Path(__file__).resolve().parents[1]
DT = 1.0 / 60.0
VELOCITIES = ("Y_root_vel", "Y_root_vrt", "Y_lvel", "Y_lvrt")
STATS = ("audio_input_mean", "audio_input_std", "anim_input_mean", "anim_input_std",
         "anim_output_mean", "anim_output_std")


def _conf(pkg, root, out, **kw):
    return pkg.PipelineConfig(
        base_path=str(root), processed_data_path=out, info_filename="info.csv",
        audio_conf=pkg.MelConfig(normalize_loudness=False), len_ratios=(0.9, 1.0),
        save_trimmed_audio=False, save_trimmed_animation=False, **kw)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw_corpus")
    write_raw_corpus(root, n_clips=3, seconds=4.0)
    jax_data, jax_def = jpipe.data_pipeline(_conf(JC, root, "jax"))
    return dict(root=root, jax=jax_data, jax_def=jax_def)


def test_pipeline_matches_jax(corpus):
    root = corpus["root"]
    ours, definition = tpipe.data_pipeline(_conf(TC, root, "port"), device="cpu")
    ref = corpus["jax"]
    assert definition == corpus["jax_def"]
    assert (json.loads((root / "port" / "data_definition.json").read_text())
            == json.loads((root / "jax" / "data_definition.json").read_text()))
    assert set(ours) == set(ref)
    for k in ref:
        a, b = ours[k], np.asarray(ref[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k.startswith("ranges"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif k == "X_audio_features":
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=0, err_msg=k)
        elif k in STATS:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(), err_msg=k)
        else:
            scale = DT if k in VELOCITIES else 1.0
            np.testing.assert_allclose(a * scale, b * scale, atol=1e-5, rtol=0, err_msg=k)
    with np.load(root / "port" / "stats.npz") as s:
        assert sorted(s.files) == sorted(set(ref) - {k for k in ref if k[:2] in ("X_", "Y_")})
    summary = [pkg.dataset_summary(d["label_names"], r["ranges_train"], r["ranges_train_labels"],
                                   r["ranges_valid"], r["ranges_valid_labels"])
               for pkg, d, r in ((tpipe, definition, ours), (jpipe, corpus["jax_def"], ref))]
    assert summary[0] == summary[1]
    assert tpipe.format_summary_ascii(summary[0]) == jpipe.format_summary_ascii(summary[1])
    # the same page but for the config's output directory
    html = (root / "port" / "data_info.html").read_text()
    assert html.count('"processed_data_path": "port"') == 1
    assert (html.replace('"processed_data_path": "port"', '"processed_data_path": "jax"')
            == (root / "jax" / "data_info.html").read_text())


def test_sharded_run_merges_to_the_serial_run(corpus):
    root = corpus["root"]
    for i in range(3):
        assert tpipe.data_pipeline(_conf(TC, root, "shards", save_final_data=False),
                                   process_index=i, process_count=3, device="cpu") == (None, None)
    merged, merged_def = tpipe.merge_shards(_conf(TC, root, "shards", save_final_data=False), 3)
    serial, serial_def = tpipe.data_pipeline(_conf(TC, root, "serial", save_final_data=False),
                                             device="cpu")
    assert merged_def == serial_def and set(merged) == set(serial)
    for k in serial:
        np.testing.assert_array_equal(merged[k], serial[k], err_msg=k)


def test_process_pool_equals_the_serial_run(corpus):
    """Spawned workers, each on the device it is given, give the serial
    run's arrays."""
    root = corpus["root"]
    conf = dataclasses.replace(_conf(TC, root, "pool", save_final_data=False), len_ratios=(1.0,))
    pooled, _ = tpipe.data_pipeline(conf, num_workers=2, device="cpu")
    serial, _ = tpipe.data_pipeline(dataclasses.replace(conf, processed_data_path="pool_serial"),
                                    device="cpu")
    for k in serial:
        np.testing.assert_array_equal(pooled[k], serial[k], err_msg=k)


def test_cli_pipeline_on_the_cpu(corpus, tmp_path, capsys):
    conf = dataclasses.replace(_conf(TC, corpus["root"], str(tmp_path / "cli")),
                               len_ratios=(1.0,))
    path = tmp_path / "conf.json"
    path.write_text(json.dumps(conf.to_dict()))
    cli.main(["-c", str(path), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["labels"] == ["Happy", "Neutral", "Sad"] and out["frames"] == 3 * 180
    assert (tmp_path / "cli" / "processed_data.npz").exists()


@pytest.mark.parametrize("flag", ["save_normalized_animations", "visualize_gaze",
                                  "visualize_spectrogram"])
def test_debug_artifacts_are_refused(corpus, flag):
    """Each debug flag writes its artifacts as zeggs_tpu's pipeline does
    (the test keeps its name from when the port refused these flags): the
    normalised BVHs equal JAX's (positions 1e-4 cm, rotations 1e-5 as
    matrices), and the plots are PNG files."""
    root, out = corpus["root"], f"debug_{flag}"
    conf = dataclasses.replace(_conf(TC, root, out, save_final_data=False), len_ratios=(1.0,),
                               **{flag: True})
    tpipe.data_pipeline(conf, device="cpu")
    written = sorted(p.name for p in (root / out / "normalized_animations").iterdir())
    names = [f"{i:03d}_Synth_{i}_x_1_0" for i in range(3)]
    if flag != "save_normalized_animations":
        suffix = "_gaze.png" if flag == "visualize_gaze" else "_spec.png"
        assert written == [n + suffix for n in names]
        for n in written:
            assert (root / out / "normalized_animations" / n).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        return
    assert written == sorted(n + s for n in names for s in ("_denorm.bvh", "_norm.bvh"))
    jconf = dataclasses.replace(_conf(JC, root, "jax_" + out, save_final_data=False),
                                len_ratios=(1.0,), save_normalized_animations=True)
    jpipe.data_pipeline(jconf)
    for name in written:
        ours = tbvh.load(root / out / "normalized_animations" / name)
        ref = tbvh.load(root / ("jax_" + out) / "normalized_animations" / name)
        np.testing.assert_allclose(ours["positions"], ref["positions"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(*(
            xform.from_euler(torch.as_tensor(np.radians(a["rotations"].astype(np.float64))),
                             a["order"]).numpy() for a in (ours, ref)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_configs_read_to_the_jax_values(version):
    ours = TC.Options.from_options_json(REPO / "configs" / f"configs_{version}.json")
    ref = JC.Options.from_options_json(REPO / "configs" / f"configs_{version}.json")
    assert ours.to_options_dict() == ref.to_options_dict()
    conf = REPO / "configs" / f"data_pipeline_conf_{version}.json"
    assert TC.PipelineConfig.from_json(conf).to_dict() == JC.PipelineConfig.from_json(conf).to_dict()
