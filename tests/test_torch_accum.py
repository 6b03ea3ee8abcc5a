"""uml_tpu_torch.train.accum against uml_tpu.train.accum (CPU, fp32).

``pick_microbatch`` gives uml_tpu's answers; ``microbatched_step`` on the
tanh MLP of tests/test_accum.py, from the same numpy parameters and
batch, gives ``microbatched_value_and_grad``'s loss and gradients within
1e-5 of their largest entry, the full-batch step's by the mean-of-means
identity, and is one plain step when the microbatch covers the batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.train import accum as jaccum
from uml_tpu_torch.ops.ln_matmul import MLP_STASH_MAX_BYTES
from uml_tpu_torch.train import accum as taccum

REL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(b=32, d=16, h=24, c=5, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w1": (rng.standard_normal((d, h)) * 0.3).astype(np.float32),
              "b1": np.zeros(h, np.float32),
              "w2": (rng.standard_normal((h, c)) * 0.3).astype(np.float32)}
    x = rng.standard_normal((b, d)).astype(np.float32)
    labels = rng.integers(0, c, b).astype(np.int32)
    return params, x, labels


def _jax_loss(params, x, labels):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    logits = h @ params["w2"]
    onehot = jax.nn.one_hot(labels, logits.shape[-1])
    return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))


def _torch_step(params, x, labels, micro):
    """-> (loss, {name: grad}) of microbatched_step over the same loss."""
    names = list(params)
    leaves = [torch.tensor(params[n], requires_grad=True) for n in names]
    p = dict(zip(names, leaves))

    def loss_fn(xb, lb):
        logits = torch.tanh(xb @ p["w1"] + p["b1"]) @ p["w2"]
        return torch.nn.functional.cross_entropy(logits, lb)

    loss, grads = taccum.microbatched_step(
        loss_fn, leaves, torch.tensor(x), torch.tensor(labels, dtype=torch.int64),
        microbatch=micro)
    return loss, dict(zip(names, grads))


def _close(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), f"{name}: {err}"


@pytest.mark.parametrize("batch,seq,hidden3,mlp", [
    (128, 197, 2304, 3072), (512, 197, 2304, 3072), (256, 197, 2304, 3072),
    (8, 17, 96, 128), (212, 197, 2304, 3072), (211, 197, 2304, 3072),
    (96, 257, 3072, 4096), (300, 77, 1536, 2048)])
def test_pick_microbatch_matches_jax(batch, seq, hidden3, mlp):
    from uml_tpu.ops.ln_matmul import MLP_STASH_MAX_BYTES as JAX_MAX

    assert MLP_STASH_MAX_BYTES == JAX_MAX
    assert taccum.pick_microbatch(batch, seq, hidden3, mlp) == \
        jaccum.pick_microbatch(batch, seq, hidden3, mlp)


def test_pick_microbatch_sweep_matches_jax():
    for batch in range(1, 1025, 7):
        for seq in (50, 197, 257):
            assert taccum.pick_microbatch(batch, seq, 2304, 3072, 2) == \
                jaccum.pick_microbatch(batch, seq, 2304, 3072, 2), (batch, seq)


@pytest.mark.parametrize("micro", [4, 8, 16])
def test_microbatched_step_matches_jax(micro):
    params, x, labels = _setup()
    jp = jax.tree.map(jnp.asarray, params)
    jloss, jgrads = jaccum.microbatched_value_and_grad(_jax_loss, micro)(
        jp, jnp.asarray(x), jnp.asarray(labels))
    loss, grads = _torch_step(params, x, labels, micro)
    _close(loss, jloss, "loss")
    for name in params:
        _close(grads[name], jgrads[name], name)


@pytest.mark.parametrize("micro", [4, 8, 16])
def test_microbatched_step_is_the_full_batch_step(micro):
    params, x, labels = _setup(seed=1)
    loss_f, grads_f = _torch_step(params, x, labels, 32)
    loss_m, grads_m = _torch_step(params, x, labels, micro)
    _close(loss_m, loss_f.detach(), "loss")
    for name in params:
        _close(grads_m[name], grads_f[name], name)


def test_microbatch_ge_batch_is_one_plain_step():
    params, x, labels = _setup(b=8)
    loss, grads = _torch_step(params, x, labels, 64)
    leaves = {n: torch.tensor(a, requires_grad=True) for n, a in params.items()}
    logits = torch.tanh(torch.tensor(x) @ leaves["w1"] + leaves["b1"]) @ leaves["w2"]
    want = torch.nn.functional.cross_entropy(logits, torch.tensor(labels, dtype=torch.int64))
    want_grads = torch.autograd.grad(want, list(leaves.values()))
    assert loss.item() == want.item()
    for name, g in zip(leaves, want_grads):
        assert torch.equal(grads[name], g), name


def test_indivisible_batch_raises():
    params, x, labels = _setup(b=12)
    with pytest.raises(ValueError):
        _torch_step(params, x, labels, 8)


def test_unused_parameter_gets_a_zero_gradient():
    w = torch.ones(3, requires_grad=True)
    unused = torch.ones(2, requires_grad=True)
    loss, (gw, gu) = taccum.microbatched_step(
        lambda xb: (xb @ w).mean(), [w, unused], torch.ones(4, 3), microbatch=2)
    assert loss.item() == 3.0
    assert torch.equal(gw, torch.ones(3)) and torch.equal(gu, torch.zeros(2))
