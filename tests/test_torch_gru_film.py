"""The ``gru`` style body and the ``film`` decoder cell of zeggs_tpu_torch on
the CPU, against zeggs_tpu: the body with and without lengths (atol 1e-5),
a 40-frame FiLM rollout (pose MAE < 1e-4 at fp32), and whole requests
through `generate_gesture` with a gru/FiLM model (BVH MAE < 1e-3,
docs/DESIGN.md section 5). Batched FiLM requests equal single ones, and a
streaming session refuses the FiLM cell, as the reference's does.

Networks are initialised by the JAX package and read by both packages
from the same files; the JAX side runs at temperature 0 (jax.random and
torch.Generator draw different numbers).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zeggs_tpu import config as JC
from zeggs_tpu.infer import GesturePipeline as JaxPipeline
from zeggs_tpu.infer import generate_gesture as jax_generate
from zeggs_tpu.io import bvh, checkpoint
from zeggs_tpu.models import decoder as jdec
from zeggs_tpu.models import style_encoder as jst
from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.infer import GesturePipeline, generate_gesture
from zeggs_tpu_torch.infer.batch import Request, generate_batch
from zeggs_tpu_torch.io import weights
from zeggs_tpu_torch.models import decoder as tdec
from zeggs_tpu_torch.models.decoder import Decoder
from zeggs_tpu_torch.models.style_encoder import StyleEncoder
from tests.synthetic import POSE_IN, POSE_OUT, write_corpus

DT = 1.0 / 60.0
NFRAMES = 120
S, C, H = 16, 8, 32


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("lengths", [None, [50, 23, 1]])
def test_gru_style_body_matches_jax(lengths):
    params = jst.init(jax.random.PRNGKey(3), POSE_IN, 24, C, encoder_type="gru", use_vae=True)
    enc = StyleEncoder(POSE_IN, 24, C, use_vae=True, encoder_type="gru")
    enc.load_state_dict(weights.from_jax(_np(params)), strict=True)
    x = _x(3, 50, POSE_IN, seed=4)
    lj = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    ref = jst.apply(params, jnp.asarray(x), lengths=lj, encoder_type="gru", style_embedding_size=C)
    with torch.no_grad():
        ours = enc(torch.as_tensor(x), lengths=None if lengths is None else torch.tensor(lengths))
    for a, b in zip(ours, ref):  # embedding (= mu), mu, logvar
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_film_rollout_matches_jax():
    params = jdec.init(jax.random.PRNGKey(5), POSE_IN, POSE_OUT, S, C, H, 2, "film")
    dec = Decoder(POSE_IN, POSE_OUT, S, C, H, 2, "film")
    dec.load_state_dict(weights.from_jax(_np(params)), strict=True)
    rng = np.random.default_rng(6)
    J = (POSE_OUT - 6) // 15
    q = rng.normal(size=(2, 4))
    state0 = [rng.normal(size=(2, 3)), q / np.linalg.norm(q, axis=-1, keepdims=True),
              rng.normal(size=(2, 3)) * 0.1, rng.normal(size=(2, 3)) * 0.1,
              rng.normal(size=(2, J, 3)), rng.normal(size=(2, J, 2, 3)),
              rng.normal(size=(2, J, 3)) * 0.1, rng.normal(size=(2, J, 3)) * 0.1]
    T = 40
    cond = [rng.normal(size=(2, T, 3)) * 100, rng.normal(size=(2, T, S)),
            np.repeat(rng.normal(size=(2, 1, C)), T, axis=1)]
    stats = [rng.normal(size=POSE_IN) * 0.1, rng.uniform(0.5, 2.0, POSE_IN),
             rng.normal(size=POSE_OUT) * 0.1, rng.uniform(0.05, 0.5, POSE_OUT)]
    args = [np.asarray(a, np.float32) for a in state0 + cond + stats]
    ref = jdec.rollout(params, *map(jnp.asarray, args), DT, rnn_cond="film")
    with torch.no_grad():
        ours = tdec.rollout(dec, *map(torch.as_tensor, args), DT)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        assert np.abs(a.numpy() - np.asarray(b)).mean() < 1e-4


# -- whole requests with a gru style encoder and a film decoder ---------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("gru_film_corpus")
    data_dir, net_dir, clips, opts = write_corpus(root, n_clips=3, nframes=NFRAMES)
    se = dataclasses.replace(opts.net.style_encoder, type="gru")
    dc = dataclasses.replace(opts.net.decoder, rnn_cond="film")
    opts = dataclasses.replace(opts, net=dataclasses.replace(opts.net, style_encoder=se,
                                                             decoder=dc))
    checkpoint.save(net_dir / "style_encoder.npz",
                    jst.init(jax.random.PRNGKey(7), POSE_IN, se.nhidden,
                             se.style_encoding_size, encoder_type="gru", use_vae=True))
    checkpoint.save(net_dir / "decoder.npz",
                    jdec.init(jax.random.PRNGKey(8), POSE_IN, POSE_OUT,
                              opts.net.speech_encoder.speech_encoding_size,
                              se.style_encoding_size, dc.nhidden, 2, "film"))
    od = opts.to_options_dict()
    od["paths"] = {"base_path": str(root), "path_processed_data": "processed",
                   "output_dir": str(root / "out"), "models_dir": str(net_dir)}
    (root / "options.json").write_text(json.dumps(od))
    return dict(root=root, data=data_dir, nets=net_dir, clips=clips,
                opts=JC.Options.from_options_dict(od), topts=TC.Options.from_options_dict(od))


def _port(c):
    return GesturePipeline(c["nets"], c["data"], options=c["topts"], device="cpu")


def _mae(a_path, b_path):
    a, b = bvh.load(a_path), bvh.load(b_path)
    assert a["rotations"].shape == b["rotations"].shape
    return max(np.abs(a["positions"] - b["positions"]).mean(),
               np.abs(a["rotations"] - b["rotations"]).mean())


def test_generate_gesture_gru_film_matches_jax(corpus, tmp_path):
    c = corpus
    styles = [(c["clips"][0][0], None)]
    kw = dict(audio_file=c["clips"][1][1], styles=styles, network_path=c["nets"],
              data_path=c["data"], file_name="gru_film", temperature=0.0)
    ref = jax_generate(results_path=tmp_path / "jax",
                       pipeline=JaxPipeline(c["nets"], c["data"], options=c["opts"]), **kw)
    pipe = _port(c)
    assert pipe.networks["style_encoder"].encoder_type == "gru"
    assert pipe.networks["decoder"].rnn_cond == "film" and pipe._fused_fn is None
    enc = generate_gesture(results_path=tmp_path / "port", pipeline=pipe, **kw)
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    assert _mae(tmp_path / "port" / "gru_film.bvh", tmp_path / "jax" / "gru_film.bvh") < 1e-3


def test_generate_batch_film_equals_single_requests(corpus, tmp_path):
    c = corpus
    pipe = _port(c)
    reqs = [Request(audio=c["clips"][i][1], styles=[(c["clips"][(i + 1) % 3][0], None)],
                    file_name=f"film_{i}", temperature=1.0, seed=11 + i) for i in range(3)]
    written = generate_batch(pipe, reqs, tmp_path / "batch", bucket=64)
    assert len(written) == 3
    for r in reqs:
        generate_gesture(r.audio, r.styles, None, None, tmp_path / "single",
                         file_name=r.file_name, temperature=r.temperature, seed=r.seed,
                         pipeline=pipe)
        assert _mae(tmp_path / "batch" / f"{r.file_name}.bvh",
                    tmp_path / "single" / f"{r.file_name}.bvh") < 1e-4


def test_streaming_refuses_film(corpus):
    with pytest.raises(NotImplementedError, match="normal"):
        _port(corpus).streaming_session([(corpus["clips"][0][0], None)])
