"""zeggs_tpu_torch.models against zeggs_tpu.models, through the weight bridge.

Each network is initialised by the JAX package, carried over with
`io.weights.from_jax`, and fed the same numpy inputs. Tolerance atol 2e-5:
the same float32 math with sums taken in another order.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from zeggs_tpu.models import decoder as jdec
from zeggs_tpu.models import layers as JL
from zeggs_tpu.models import speech_encoder as jse
from zeggs_tpu.models import style_encoder as jst
from zeggs_tpu_torch.io import weights
from zeggs_tpu_torch.models import decoder as tdec
from zeggs_tpu_torch.models import layers as TL
from zeggs_tpu_torch.models.decoder import Decoder
from zeggs_tpu_torch.models.speech_encoder import SpeechEncoder
from zeggs_tpu_torch.models.style_encoder import StyleEncoder

ATOL = 2e-5
POSE_IN, POSE_OUT, S, C, H = 129, 126, 16, 8, 32


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _load(module, params):
    module.load_state_dict(weights.from_jax(_np_tree(params)), strict=True)
    return module.eval()


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(ours, ref):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("k,padding", [(1, "replicate"), (3, "zero"), (4, "zero"), (31, "replicate")])
def test_conv1d_matches_jax(k, padding):
    params = JL.conv1d_init(jax.random.PRNGKey(k), 12, 10, k)
    conv = _load(nn.Conv1d(12, 10, k), params)
    x = _x(2, 40, 12)
    _close(TL.conv1d(torch.as_tensor(x), conv, padding=padding), JL.conv1d(params, jnp.asarray(x), padding=padding))


def test_linear_layer_norm_gru_cell_match_jax():
    x, h = _x(3, 20, seed=1), _x(3, 16, seed=2)
    lin_p = JL.linear_init(jax.random.PRNGKey(1), 20, 16)
    _close(TL.linear(torch.as_tensor(x), _load(nn.Linear(20, 16), lin_p)), JL.linear(lin_p, jnp.asarray(x)))
    ln_p = {"scale": jnp.asarray(_x(20, seed=3)), "bias": jnp.asarray(_x(20, seed=4))}
    _close(TL.layer_norm(torch.as_tensor(x), _load(nn.LayerNorm(20), ln_p)), JL.layer_norm(ln_p, jnp.asarray(x)))
    gru_p = JL.gru_layer_init(jax.random.PRNGKey(2), 20, 16)
    cell = _load(nn.GRUCell(20, 16), gru_p)
    ref = JL.gru_cell(gru_p, jnp.asarray(x), jnp.asarray(h))
    _close(TL.gru_cell(torch.as_tensor(x), torch.as_tensor(h), cell), ref)
    # PyTorch's own GRUCell agrees: the gate order and equations are torch's
    _close(cell(torch.as_tensor(x), torch.as_tensor(h)), ref)


def test_speech_encoder_matches_jax():
    params = jse.init(jax.random.PRNGKey(5), 81, 16, S)
    enc = _load(SpeechEncoder(81, 16, S), params)
    x = _x(2, 90, 81, seed=5)
    with torch.no_grad():
        _close(enc(torch.as_tensor(x)), jse.apply(params, jnp.asarray(x)))


def _style_pair(seed=6):
    params = jst.init(jax.random.PRNGKey(seed), POSE_IN, 24, C, encoder_type="attn", use_vae=True)
    return params, _load(StyleEncoder(POSE_IN, 24, C, use_vae=True), params)


def test_style_encoder_masked_batch_matches_jax():
    """A padded batch with true lengths below T: masking, the finfo.min
    logits and the mean over the true length."""
    params, enc = _style_pair()
    x = _x(3, 64, POSE_IN, seed=7)
    lengths = np.array([64, 37, 5], np.int32)
    ref = jst.apply(params, jnp.asarray(x), lengths=jnp.asarray(lengths), style_embedding_size=C)
    with torch.no_grad():
        ours = enc(torch.as_tensor(x), lengths=torch.as_tensor(lengths))
    for a, b in zip(ours, ref):  # embedding (= mu), mu, logvar
        _close(a, b)


def test_style_encoder_unpadded_equals_padded():
    """The port runs one example at its own length; the masks make that
    equal to the reference's padded, length-masked call."""
    params, enc = _style_pair()
    x = _x(1, 64, POSE_IN, seed=8)
    ref = jst.apply(params, jnp.asarray(x), lengths=jnp.asarray([41]), style_embedding_size=C)
    with torch.no_grad():
        ours = enc(torch.as_tensor(x[:, :41]))
    for a, b in zip(ours, ref):
        _close(a, b)


def test_style_encoder_vae_draw_follows_the_generator():
    _, enc = _style_pair()
    x = torch.as_tensor(_x(1, 30, POSE_IN, seed=9))
    with torch.no_grad():
        draws = [enc(x, temperature=1.5, generator=torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
        _, mu, logvar = enc(x)
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(draws[0], mu + eps * torch.exp(0.5 * logvar) / 1.5)


def _decoder_pair(seed=10):
    params = jdec.init(jax.random.PRNGKey(seed), POSE_IN, POSE_OUT, S, C, H, 2, "normal")
    return params, _load(Decoder(POSE_IN, POSE_OUT, S, C, H), params)


def test_cell_state_encoder_matches_jax():
    params, dec = _decoder_pair()
    pose, style = _x(2, POSE_IN, seed=11), _x(2, C, seed=12)
    ref = jdec.cell_state_encoder(params["cell_state_encoder"], jnp.asarray(pose), jnp.asarray(style))
    with torch.no_grad():
        ours = tdec.cell_state_encoder(dec.cell_state_encoder, torch.as_tensor(pose), torch.as_tensor(style))
    assert tuple(ours.shape) == (2, 2, H)
    _close(ours, ref)


@pytest.mark.parametrize("network", ["speech_encoder", "style_encoder", "decoder"])
def test_weight_bridge_is_bit_exact(network):
    """Every parameter is carried over bit for bit, and `to_jax` gives the
    JAX pytree back unchanged."""
    if network == "speech_encoder":
        params = _np_tree(jse.init(jax.random.PRNGKey(1), 81, 16, S))
        module = _load(SpeechEncoder(81, 16, S), params)
    elif network == "style_encoder":
        params, module = _style_pair()
        params = _np_tree(params)
    else:
        params, module = _decoder_pair()
        params = _np_tree(params)
    sd = weights.from_jax(params)
    assert set(sd) == set(module.state_dict())
    for name, value in module.state_dict().items():
        assert value.dtype == torch.float32 and torch.equal(value, sd[name]), name
    back = weights.to_jax(module)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))
