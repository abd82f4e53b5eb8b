"""zeggs_tpu_torch.train against zeggs_tpu.train on the CPU: the 18 loss
terms, the KL anneal, the gradients of the deterministic loss, RAdam and
whole deterministic train steps.

Networks are initialised by the JAX package and carried over with
`io.weights`; batches are random arrays made from a numpy seed (small
widths, 8 joints, 16-frame windows). Tolerances: loss terms rtol 1e-5 /
atol 1e-6; gradients per leaf max|diff| <= 1e-4 * max(1, max|g_jax|);
RAdam 1e-6; parameters after three steps 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from zeggs_tpu import config as JC
from zeggs_tpu.train import loop as jloop
from zeggs_tpu.train import loss as jloss
from zeggs_tpu.train import radam as jradam
from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.io import weights
from zeggs_tpu_torch.models import decoder as D
from zeggs_tpu_torch.ops.kernels import gru_cell as GC
from zeggs_tpu_torch.train import loop as tloop
from zeggs_tpu_torch.train import loss as tloss
from zeggs_tpu_torch.train import radam as tradam
from tests.synthetic import LABELS, NJOINTS, PARENTS, POSE_IN, POSE_OUT, small_options

DT = 1.0 / 60.0
B, T, L_EX = 3, 16, 40


def _traj(seed, B=2, T=5, J=NJOINTS):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return {
        "root_pos": rng.normal(size=(B, T, 3)).astype(np.float32),
        "root_rot": q,
        "root_vel": rng.normal(size=(B, T, 3)).astype(np.float32),
        "root_vrt": rng.normal(size=(B, T, 3)).astype(np.float32),
        "lpos": rng.normal(size=(B, T, J, 3)).astype(np.float32),
        "ltxy": rng.normal(size=(B, T, J, 2, 3)).astype(np.float32),
        "lvel": rng.normal(size=(B, T, J, 3)).astype(np.float32),
        "lvrt": rng.normal(size=(B, T, J, 3)).astype(np.float32),
    }


def _tt(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _jt(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("iteration", [0, 7500, 20000])
def test_loss_terms_match_jax(iteration):
    O, W = _traj(1), _traj(2)
    rng = np.random.default_rng(3)
    gaze = rng.normal(size=(2, 5, 3)).astype(np.float32) * 50
    mu, logvar = rng.normal(size=(2, 8)).astype(np.float32), rng.normal(size=(2, 8)).astype(
        np.float32) * 0.3
    ref_loss, ref = jloss.compute_loss(_jt(O), _jt(W), jnp.asarray(gaze), PARENTS, DT,
                                       jnp.asarray(mu), jnp.asarray(logvar), iteration)
    loss, ours = tloss.compute_loss(_tt(O), _tt(W), torch.as_tensor(gaze), PARENTS, DT,
                                    torch.as_tensor(mu), torch.as_tensor(logvar), iteration)
    assert set(ours) == set(ref) and len(ours) == 19  # 18 terms and the total
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("iteration", [0, 7500, 20000])
def test_kl_anneal_matches_jax(iteration):
    rng = np.random.default_rng(iteration)
    mu, logvar = (rng.normal(size=(4, 8)).astype(np.float32) for _ in range(2))
    kl_j, w_j = jloss.kl_divergence(jnp.asarray(mu), jnp.asarray(logvar), iteration)
    kl_t, w_t = tloss.kl_divergence(torch.as_tensor(mu), torch.as_tensor(logvar), iteration)
    np.testing.assert_allclose(kl_t.numpy(), np.asarray(kl_j), rtol=1e-6)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6, atol=0)
    assert (float(w_t) == pytest.approx(0.2)) == (iteration >= 7500)


# -- networks and batches --------------------------------------------------

CONFIGS = {
    "attn_normal": dict(type="attn", rnn_cond="normal", style="example"),
    "gru_normal": dict(type="gru", rnn_cond="normal", style="example"),
    "attn_film": dict(type="attn", rnn_cond="film", style="example"),
    "label": dict(type="attn", rnn_cond="normal", style="label"),
}


def _opts(kind, lr=1e-4, compute_dtype="float32"):
    c = CONFIGS[kind]
    base = small_options()
    net = dataclasses.asdict(base.net)
    net["decoder"]["rnn_cond"] = c["rnn_cond"]
    net["style_encoder"]["type"] = c["type"]
    train = dict(batchsize=B, window=T, style_encoding_type=c["style"], learning_rate=lr,
                 compute_dtype=compute_dtype)
    od = {"net_opt": net, "train_opt": train}
    return JC.Options.from_options_dict(od), TC.Options.from_options_dict(od)


def _stats(seed=4):
    rng = np.random.default_rng(seed)
    return dict(
        audio_input_mean=rng.normal(size=81).astype(np.float32) * 0.1,
        audio_input_std=np.float32(1.3),
        anim_input_mean=rng.normal(size=POSE_IN).astype(np.float32) * 0.1,
        anim_input_std=rng.uniform(0.5, 2.0, POSE_IN).astype(np.float32),
        anim_output_mean=rng.normal(size=POSE_OUT).astype(np.float32) * 0.1,
        anim_output_std=rng.uniform(0.05, 0.5, POSE_OUT).astype(np.float32),
    )


def _batch(style, seed=5, frames=T):
    """A batch of ``frames``-frame windows: the first ``frames`` of the
    T-frame batch that the same seed makes."""
    rng = np.random.default_rng(seed)
    b = _traj(seed, B=B, T=T)
    b["root_pos"] = b["root_pos"] * 10
    b["audio_features"] = rng.normal(size=(B, T, 81)).astype(np.float32)
    b["gaze_pos"] = np.repeat(rng.normal(size=(B, 1, 3)).astype(np.float32) * 100, T, axis=1)
    b = {k: v[:, :frames] for k, v in b.items()}
    if style == "label":
        b["style"] = np.eye(len(LABELS), dtype=np.float32)[rng.integers(0, len(LABELS), B)]
    else:
        lengths = np.array([L_EX, 29, 17], np.int32)
        ex = rng.normal(size=(B, L_EX, POSE_IN)).astype(np.float32)
        ex[np.arange(L_EX)[None, :] >= lengths[:, None]] = 0.0
        b["example"], b["example_lengths"] = ex, lengths
    return b


def _networks(jopts, topts, seed=0):
    dims = dict(num_audio_features=81, pose_input_size=POSE_IN, pose_output_size=POSE_OUT)
    params = jloop.init_networks(jax.random.PRNGKey(seed), jopts, dims, len(LABELS))
    nets = tloop.init_networks(topts, dims, len(LABELS), seed, device="cpu")
    for name, module in nets.items():
        module.load_state_dict(weights.from_jax(params[name]), strict=True)
    return params, nets


def _grads_to_jax(nets):
    return {n: weights.to_jax(m, {k: p.grad for k, p in m.named_parameters()})
            for n, m in nets.items()}


def _assert_trees_close(ours, ref, scale_tol):
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_ours = dict(jax.tree_util.tree_leaves_with_path(ours))
    assert len(flat_ref) == len(flat_ours)
    for path, leaf in flat_ref:
        leaf = np.asarray(leaf)
        tol = scale_tol * max(1.0, float(np.abs(leaf).max()))
        err = float(np.abs(flat_ours[path] - leaf).max())
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)


def jax_value_and_grad(jopts, stats, params, batch):
    """(loss, metrics), grads of the JAX package's deterministic loss as a
    function of the iteration, compiled once at the backend's lowest
    optimisation level (compile time dominates these tests)."""
    jfn = jloop.make_loss_fn(jopts, stats, PARENTS, DT, deterministic=True)
    args = (jax.tree.map(jnp.asarray, params), _jt(batch), jnp.float32(0), jax.random.PRNGKey(9))
    compiled = jax.jit(jax.value_and_grad(jfn, has_aux=True)).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return lambda p, it: compiled(p, args[1], jnp.float32(it), args[3])


def check_gradients(kind, compute_dtype="float32", frames=T, loss_rtol=1e-5, grad_tol=1e-4):
    """Every leaf's gradient of the deterministic loss against jax.grad's,
    GRU1's biases included (a packed copy of them would carry none), with
    both packages at ``compute_dtype``. Returns the port's loss and
    gradients and JAX's gradients, as JAX trees."""
    jopts, topts = _opts(kind, compute_dtype=compute_dtype)
    params, nets = _networks(jopts, topts)
    stats, batch = _stats(), _batch(CONFIGS[kind]["style"], frames=frames)
    iteration = 7500  # the KL weight at its cap
    (jl, _), jg = jax_value_and_grad(jopts, stats, params, batch)(
        jax.tree.map(jnp.asarray, params), iteration)
    tfn = tloop.make_loss_fn(topts, stats, PARENTS, DT, deterministic=True)
    loss, _ = tfn(nets, _tt(batch), iteration)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=loss_rtol)
    ours = _grads_to_jax(nets)
    assert np.abs(ours["decoder"]["cell"]["gru1"]["b_ih"]).max() > 0
    _assert_trees_close(ours, jg, grad_tol)
    return loss.item(), ours, jg


def test_gradients_match_jax_grad():
    """attn style encoder, normal cell; the other cells and bodies are in
    tests/test_torch_train_grads.py."""
    check_gradients("attn_normal")


def test_radam_and_schedule_match_jax():
    """30 steps on a quadratic with the lr halving every 10 steps: the SGD
    branch (N_sma < 5, steps 1-5), then the rectified one."""
    w0 = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    target = np.ones((5, 3), np.float32)
    tx = jradam.radam(jradam.exponential_step_schedule(1e-2, 0.5, every=10), eps=1e-5)
    pj = {"w": jnp.asarray(w0)}
    state = tx.init(pj)
    wt = torch.as_tensor(w0.copy())
    opt = tradam.RAdam({"w": wt}, tradam.exponential_step_schedule(1e-2, 0.5, every=10),
                       eps=1e-5)
    for _ in range(30):
        g = jax.grad(lambda p: jnp.sum((p["w"] - target) ** 2 * jnp.arange(1.0, 4.0)))(pj)
        updates, state = tx.update(g, state, pj)
        pj = optax.apply_updates(pj, updates)
        opt.step({"w": torch.as_tensor(np.array(g["w"]))})
        np.testing.assert_allclose(wt.numpy(), np.asarray(pj["w"]), atol=1e-6, rtol=0)
    assert opt.step_count == int(state.step) == 30
    np.testing.assert_allclose(opt.exp_avg["w"].numpy(), np.asarray(state.exp_avg["w"]),
                               atol=1e-6)
    np.testing.assert_allclose(opt.exp_avg_sq["w"].numpy(), np.asarray(state.exp_avg_sq["w"]),
                               atol=1e-6)
    js = jradam.exponential_step_schedule(1e-4, 0.995, every=1000)
    ts = tradam.exponential_step_schedule(1e-4, 0.995, every=1000)
    for step in (0, 999, 1000, 1001, 2500):
        assert ts(step) == pytest.approx(float(js(jnp.asarray(step))), rel=1e-6)


def test_three_train_steps_match_jax():
    jopts, topts = _opts("attn_normal", lr=1e-3)
    params, nets = _networks(jopts, topts, seed=1)
    stats, batch = _stats(6), _batch("example", seed=7)
    tx = jloop.make_optimizer(jopts)
    update = jax.jit(tx.update)
    pj = jax.tree.map(jnp.asarray, params)
    state = tx.init(pj)
    grad = jax_value_and_grad(jopts, stats, params, batch)
    _, step = tloop.make_train_step(topts, stats, PARENTS, DT, nets, deterministic=True)
    for i in range(3):
        g = grad(pj, i)[1]
        updates, state = update(g, state, pj)
        pj = optax.apply_updates(pj, updates)
        step(_tt(batch), i)
    ours = {n: weights.to_jax(m) for n, m in nets.items()}
    _assert_trees_close(ours, pj, 1e-5)


def test_gru_kernel_wrappers_refuse_autograd():
    cell = torch.nn.GRUCell(16, 8)
    x, h = torch.zeros(2, 16), torch.zeros(2, 8)
    with pytest.raises(RuntimeError, match="inference only"):
        GC.pack_gru(cell)
    with torch.no_grad():
        packed = GC.pack_gru(cell)
    with pytest.raises(RuntimeError, match="inference only"):
        GC.fused_gru_cell(packed, x.requires_grad_(), h)
    with torch.no_grad():
        assert GC.fused_gru_cell(packed, x, h).shape == (2, 8)


def test_train_step_never_reaches_the_gru_kernel(monkeypatch):
    """The training rollout is the differentiable plain step: the kernel
    wrappers are never called, while inference still takes them."""
    def refuse(*_):
        raise AssertionError("kernel wrapper called in a train step")

    jopts, topts = _opts("attn_normal")
    _, nets = _networks(jopts, topts)
    monkeypatch.setattr(GC, "pack_gru", refuse)
    _, step = tloop.make_train_step(topts, _stats(), PARENTS, DT, nets)
    metrics = step(_tt(_batch("example")), 0, torch.Generator().manual_seed(0))
    assert np.isfinite(metrics["total_loss"].item())
    with torch.no_grad(), pytest.raises(AssertionError, match="kernel wrapper"):
        b = _tt(_batch("example"))
        D.rollout(nets["decoder"], *(b[k][:, 0] for k in tloop.POSE_KEYS), b["gaze_pos"],
                  torch.zeros(B, T, 16), torch.zeros(B, T, 8),
                  *(torch.as_tensor(v) for k, v in _stats().items() if k.startswith("anim")), DT)
