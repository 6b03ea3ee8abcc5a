"""The port's MultiBench self-supervised path against uml_tpu's, on the CPU.

Small widths (zdim 10, 5 heads of 2, the fixture of tests/test_multibench.py).
Every value comparison carries uml_tpu's flax weights into the port
(models/convert.py) and runs without dropout: jax.random's masks cannot be
reproduced, so the port's dropout is held statistically instead (its rate
and scale, and that one generator seed gives one output), and its init by
the distributions flax draws.

* ``SeqUML``: every key of the output dict at 1e-5 (rtol and atol), for
  both critics, positions off / sinusoidal / learnable, padded rows, x
  alone, y alone, the MIMIC one-step x and ``get_embedding``;
* the train loss's gradient against ``jax.grad`` of the deterministic
  apply at 1e-5 of each tensor's largest entry;
* five Adam steps against optax (a ``step_k`` warm start: alpha_x 0 for
  the first two; and 'y' mode, where the x branch has no gradient);
* ``device_probe_scores`` against uml_tpu's.

The training loop and the CLIs: tests/test_torch_multibench_cli.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from uml_tpu.models.seq_autoencoder import make_seq_uml as jax_make_seq_uml
from uml_tpu.train import probes as jax_probes
from uml_tpu_torch.models import seq_autoencoder as sa
from uml_tpu_torch.models.convert import seq_uml_state_dict_from_jax
from uml_tpu_torch.train import probes as torch_probes
from uml_tpu_torch.train.selfsup import SelfSupTrainer

TOL = 1e-5
DX, DY, Z, T, B = 6, 10, 10, 9, 5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batch(seed, b=B, t=T, dx=DX, dy=DY, x_steps=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, x_steps or t, dx)).astype(np.float32)
    y = rng.standard_normal((b, t, dy)).astype(np.float32)
    lx = rng.integers(1, (x_steps or t) + 1, b).astype(np.int32)
    ly = rng.integers(1, t + 1, b).astype(np.int32)
    lx[0], ly[0] = x_steps or t, t
    if x_steps == 1:
        x = x[:, 0]        # MIMIC: a static [B, D] x, one step
    return x, y, lx, ly


def _models(info_nce=False, pos_embd=False, pos_learnable=False, dx=DX, dy=DY, seed=0):
    """uml_tpu's SeqUML with its variables and the port's with the same
    weights, dropout 0."""
    jm = jax_make_seq_uml(dx, dy, Z, pos_embd=pos_embd, pos_learnable=pos_learnable,
                          info_nce=info_nce)
    x, y, lx, ly = _batch(99, dx=dx, dy=dy)
    variables = jm.init(jax.random.key(seed), x, y, lx, ly)
    tm = sa.make_seq_uml(dx, dy, Z, pos_embd=pos_embd, pos_learnable=pos_learnable,
                         info_nce=info_nce, dropout=0.0)
    tm.load_state_dict(seq_uml_state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    return jm, variables, tm


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


FORWARD_CASES = {
    "mse": {}, "infonce": {"info_nce": True}, "pos_sin": {"pos_embd": True},
    "pos_learnable": {"pos_embd": True, "pos_learnable": True},
    "infonce_pos_learnable": {"info_nce": True, "pos_embd": True, "pos_learnable": True},
}


FORWARD_INPUTS = [("mse", "xy"), ("mse", "x"), ("mse", "y"), ("mse", "xy_unpadded"),
                  ("mse", "mimic"), ("infonce", "xy"), ("infonce", "y"),
                  ("infonce", "mimic"), ("pos_sin", "xy"),
                  ("pos_learnable", "xy_unpadded"), ("infonce_pos_learnable", "xy")]


@pytest.mark.parametrize("case,inputs", FORWARD_INPUTS)
def test_seq_uml_outputs_match_jax(case, inputs):
    kw = FORWARD_CASES[case]
    x, y, lx, ly = _batch(1, x_steps=1 if inputs == "mimic" else None)
    if inputs == "mimic":
        lx = np.ones(B, np.int32)
    if inputs == "xy_unpadded":
        lx = ly = None
    if inputs == "x":
        y = ly = None
    if inputs == "y":
        x = lx = None
    jm, variables, tm = _models(**kw)
    want = jm.apply(variables, x, y, lx, ly, deterministic=True)
    got = tm(*_t(x, y, lx, ly))
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], f"{case} {inputs} {key}")
    if x is not None and y is not None:
        ex, ey = jm.apply(variables, x, y, method=jm.get_embedding)
        gx, gy = tm.get_embedding(*_t(x, y))
        _close(gx, ex, "get_embedding x")
        _close(gy, ey, "get_embedding y")


@pytest.mark.parametrize("with_lengths", [True, False])
def test_seq_transformer_out_last_matches_jax(with_lengths):
    """The encoder alone with last-valid-step pooling (out_last)."""
    from uml_tpu.models.seq_autoencoder import SeqTransformer as JaxSeqTransformer

    x, _, lengths, _ = _batch(6, dx=8)
    lengths = lengths if with_lengths else None
    jt = JaxSeqTransformer(8, 10, nhead=5, num_layers=2, out_last=True)
    variables = jt.init(jax.random.key(0), x, lengths)
    tt = sa.SeqTransformer(8, 10, nhead=5, num_layers=2, out_last=True, dropout=0.0)
    tt.load_state_dict(seq_uml_state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    got = tt(*_t(x, lengths))
    assert got.shape == (B, 10)
    _close(got, jt.apply(variables, x, lengths, deterministic=True), "out_last")


def test_y_branch_is_not_key_padding_masked():
    """The reference's quirk, kept: padded y steps reach zy, padded x steps
    do not reach the valid zx."""
    _, _, tm = _models()
    x, y, lx, ly = _batch(2)
    lx[:], ly[:] = 5, 5
    base = tm(*_t(x, y, lx, ly))
    x2, y2 = x.copy(), y.copy()
    x2[:, 5:], y2[:, 5:] = 7.0, 7.0
    out = tm(*_t(x2, y2, lx, ly))
    torch.testing.assert_close(out["zx"][:, :5], base["zx"][:, :5])
    assert not torch.allclose(out["zy"][:, 5:], base["zy"][:, 5:])


def _jax_loss(jm, ax, ay, mode, batch):
    x, y, lx, ly = batch

    def loss_fn(v):
        out = jm.apply(v, x if "x" in mode else None, y if "y" in mode else None,
                       lx, ly, deterministic=True)
        return ax * out["loss_x"] + ay * out["loss_y"]

    return loss_fn


def _grads_close(tm, jax_grads, what):
    want = seq_uml_state_dict_from_jax(jax.tree.map(np.asarray, jax_grads))
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        ref = want[key].numpy()
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= TOL * scale, (what, key, err, scale)


@pytest.mark.parametrize("case", ["infonce_pos_learnable", "pos_sin"])
def test_train_loss_gradient_matches_jax(case):
    jm, variables, tm = _models(**FORWARD_CASES[case])
    batch = _batch(3)
    loss_fn = _jax_loss(jm, 0.7, 1.3, "xy", batch)
    want_loss, grads = jax.value_and_grad(loss_fn)(variables)
    out = tm(*_t(*batch))
    loss = 0.7 * out["loss_x"] + 1.3 * out["loss_y"]
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=TOL)
    _grads_close(tm, grads, case)


@pytest.mark.parametrize("mode,step_k", [("xy", 1), ("y", -1)])
def test_five_adam_steps_match_optax(mode, step_k):
    """alpha_x is 0 while step <= step_k (the warm start): dec_x and
    xproj_in get a zero gradient there (and in 'y' mode throughout), which
    optax's Adam still counts as a step.  At the CLI's lr (1e-4), every
    parameter within 1e-5, except the key slice of each qkv bias: the
    softmax cancels its gradient, so it is rounding noise, which Adam
    scales to steps of up to lr of either sign (held to 5 lr)."""
    lr = 1e-4
    jm, variables, tm = _models(info_nce=True)
    trainer = SelfSupTrainer(tm, lr=lr, seed=0, device="cpu")
    trainer.init()
    tm.load_state_dict(seq_uml_state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    tx = optax.adam(lr)
    opt_state = tx.init(variables)

    @jax.jit
    def jax_step(v, opt_state, x, y, lx, ly, ax):
        loss, grads = jax.value_and_grad(_jax_loss(jm, ax, 1.0, mode, (x, y, lx, ly)))(v)
        updates, opt_state = tx.update(grads, opt_state, v)
        return optax.apply_updates(v, updates), opt_state, loss

    for step in range(5):
        batch = _batch(10 + step)
        ax = 0.0 if step <= step_k else 1.0
        variables, opt_state, loss = jax_step(variables, opt_state, *batch, ax)
        metrics = trainer.train_step(*_t(*batch), ax, 1.0, None, mode=mode)
        assert float(metrics["train/loss"]) == pytest.approx(float(loss), rel=TOL)
    want = seq_uml_state_dict_from_jax(jax.tree.map(np.asarray, variables))
    for key, p in tm.state_dict().items():
        p, ref = p.clone(), want[key].clone()
        if key.endswith("qkv.bias"):
            k_bias = slice(Z, 2 * Z)
            assert float((p[k_bias] - ref[k_bias]).abs().max()) <= 5 * lr, key
            p[k_bias] = ref[k_bias]
        np.testing.assert_allclose(p.numpy(), ref.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=key)


def test_dropout_rate_scale_and_generator():
    x = torch.ones(200_000)
    y = sa.dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    # binomial(200000, 0.9): sigma = 134 rows
    assert abs(int(kept.sum()) - 180_000) < 4 * 134
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(sa.dropout(x, 0.1, None), x)
    model = sa.make_seq_uml(DX, DY, Z)
    model.init_random(torch.Generator().manual_seed(0))
    batch = _t(*_batch(5))
    a = model(*batch, generator=torch.Generator().manual_seed(3))["loss_y"]
    b = model(*batch, generator=torch.Generator().manual_seed(3))["loss_y"]
    c = model(*batch)["loss_y"]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_init_matches_flax_distributions():
    """Truncated lecun-normal kernels (std 1/sqrt(fan_in), cut at 2 of the
    untruncated std), zero biases, unit LayerNorms, pos_embedding N(0, 1);
    the stds of the big kernels agree with flax's draw within 3%."""
    jm, variables, _ = _models(pos_embd=True, pos_learnable=True)
    want = seq_uml_state_dict_from_jax(jax.tree.map(np.asarray, variables))
    tm = sa.make_seq_uml(DX, DY, Z, pos_embd=True, pos_learnable=True)
    tm.init_random(torch.Generator().manual_seed(0))
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    for key, w in got.items():
        ref = want[key]
        if key.endswith("bias"):
            assert not w.any(), key
        elif ".norm" in key:
            assert torch.equal(w, torch.ones_like(w)), key
        elif key.endswith("pos_embedding"):
            assert abs(float(w.std()) - 1.0) < 0.05
        else:
            fan_in = w.shape[1]
            bound = 2 * fan_in ** -0.5 / sa._TRUNC_STD
            assert float(w.abs().max()) <= bound * (1 + 1e-6), key
            assert float(ref.abs().max()) <= bound * (1 + 1e-6), key
            if w.numel() >= 10_000:
                assert abs(float(w.std()) / float(ref.std()) - 1) < 0.03, key


def test_device_probe_scores_match_uml_tpu():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((120, 12)).astype(np.float32)
    w = rng.standard_normal((12, 3))
    y = np.argmax(X @ w + 0.5 * rng.standard_normal((120, 3)), -1)
    split = (X[:80], y[:80], X[80:100], y[80:100], X[100:], y[100:])
    assert torch_probes.device_probe_scores(*split) == jax_probes.device_probe_scores(*split)
    (W, b), mu, sd = torch_probes._fit_logistic(torch.from_numpy(X[:80]),
                                                torch.from_numpy(y[:80]), 3)
    (jW, jb), jmu, jsd = jax_probes._fit_logistic(jnp.asarray(X[:80]),
                                                  jnp.asarray(y[:80]), 3)
    np.testing.assert_allclose(W.numpy(), np.asarray(jW), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(sd.numpy(), np.asarray(jsd), rtol=1e-6)


def _probe_problem(seed, n, d, k):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n + 200, d)) * rng.uniform(0.2, 3)).astype(np.float32)
    logits = X[:, :k] @ rng.standard_normal((k, k)) + rng.standard_normal((n + 200, k))
    y = logits.argmax(1) if k > 2 else (logits[:, 0] > logits[:, 1]).astype(np.int64)
    return X[:n], y[:n], X[n:], y[n:]


@pytest.mark.parametrize("kind", ["lbfgs", "multinomial", "mosi_liblinear", "knn"])
@pytest.mark.parametrize("seed,n,d", [(0, 414, 300), (1, 97, 40), (2, 240, 600)])
def test_probe_classifiers_match_sklearn(kind, seed, n, d):
    """The port's sklearn-free probes (the card's machine has no sklearn)
    against scikit-learn's on the same data: equal predictions on 200
    held-out rows and equal scores; the lbfgs coefficients within 1e-4 of
    the largest (sklearn stops at gtol 1e-4 on float32 losses, as the port
    does), liblinear's within 1e-3 (liblinear stops at its own tolerance,
    the port at the optimum)."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.neighbors import KNeighborsClassifier
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler

    X, y, Xt, yt = _probe_problem(seed, n, d, 3 if kind == "multinomial" else 2)
    if kind == "knn":
        want = KNeighborsClassifier().fit(X, y)
        got = torch_probes.make_classifier("knn", "sarcasm").fit(X, y)
    elif kind == "mosi_liblinear":
        want = make_pipeline(StandardScaler(), LogisticRegression(
            max_iter=1000, solver="liblinear")).fit(X, y)
        got = torch_probes.make_classifier("logistic", "mosi").fit(X, y)
    else:
        want = LogisticRegression(max_iter=200).fit(X, y)
        got = torch_probes.make_classifier("logistic", "sarcasm").fit(X, y)
    np.testing.assert_array_equal(got.predict(Xt), want.predict(Xt))
    assert got.score(X, y) == want.score(X, y)
    assert got.score(Xt, yt) == want.score(Xt, yt)
    if kind != "knn":
        w_want = want[-1].coef_ if kind == "mosi_liblinear" else want.coef_
        w_got = got.clf.coef_ if kind == "mosi_liblinear" else got.coef_
        bound = 1e-3 if kind == "mosi_liblinear" else 1e-4
        assert np.abs(w_got - w_want).max() <= bound * np.abs(w_want).max()
    if kind in ("lbfgs", "mosi_liblinear"):
        ds = "mosi" if kind == "mosi_liblinear" else "sarcasm"
        split = (X, y, Xt[:100], yt[:100], Xt[100:], yt[100:])
        assert torch_probes.probe_scores(*split, ds) == jax_probes.probe_scores(*split, ds)
