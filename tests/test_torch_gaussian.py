"""The port's Gaussian experiment against uml_tpu's, on the CPU.

* ``generate_data`` / ``sample_latent``: the pools bit-equal for every
  latent distribution, with and without attenuation; the
  ``UnpairedIndexStream`` batches and chunks bit-equal;
* ``SharedAutoencoder`` from uml_tpu's converted parameters: both losses,
  both reconstructions and both embeddings within 1e-6, a missing
  modality's loss a 0-d zero;
* ``train_gaussian`` from one converted init and one index stream, 200
  steps in both modes: the losses and CKA within 1e-4 relative, mutual
  kNN within 1e-3 absolute; in mode 'x' the y heads keep their initial
  values in both packages;
* ``check_finite`` (``--debug_nans``) raises at the first non-finite loss;
* the CLI: a two-combo sweep from a small yaml with ``-s`` and then all
  combos (the first is skipped: its results.json exists), writing
  uml_tpu's results.json keys and one metrics row per step.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.data import gaussian as jdata
from uml_tpu.models.shared_autoencoder import SharedAutoencoder as JaxAE
from uml_tpu.train import gaussian as jtrain
from uml_tpu_torch.data import gaussian as tdata
from uml_tpu_torch.models.convert import (shared_autoencoder_from_jax,
                                          shared_autoencoder_to_jax)
from uml_tpu_torch.models.shared_autoencoder import SharedAutoencoder
from uml_tpu_torch.train import gaussian as ttrain

LOSS_RTOL = 1e-4
MKNN_ATOL = 1e-3
AE_TOL = 1e-6
STEPS = 200
Y_HEADS = ("in_head_y", "out_head_y")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg(**kw):
    cfg = dict(seed=42, num_samples=600, dim_c=10, dim_x=5, dim_y=5, dim_obs=50,
               noise_std=0.09, attenuate_x=True, attenuation=0.05,
               shared_latent_distribution_type="gaussian")
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("attenuate", [True, False])
@pytest.mark.parametrize("dist", ["gaussian", "gmm", "laplace"])
def test_pools_are_bit_equal(dist, attenuate):
    cfg = _cfg(shared_latent_distribution_type=dist, attenuate_x=attenuate, seed=7)
    want, got = jdata.generate_data(cfg), tdata.generate_data(cfg)
    for k in ("x", "y"):
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    a = jdata.sample_latent(np.random.default_rng(3), 50, 4, dist)
    b = tdata.sample_latent(np.random.default_rng(3), 50, 4, dist)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("len_x,len_y,bs,steps,chunk",
                         [(100, 70, 16, 23, 5), (64, 64, 8, 17, 17), (50, 90, 32, 7, 3)])
def test_index_stream_is_bit_equal(len_x, len_y, bs, steps, chunk):
    js = jdata.UnpairedIndexStream(len_x, len_y, bs, seed=11)
    ts = tdata.UnpairedIndexStream(len_x, len_y, bs, seed=11)
    for (jx, jy), (tx, ty) in zip(js.batches(), ts.batches(), strict=True):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    js = jdata.UnpairedIndexStream(len_x, len_y, bs, seed=12)
    ts = tdata.UnpairedIndexStream(len_x, len_y, bs, seed=12)
    pairs = list(zip(js.batch_chunks(steps, chunk), ts.batch_chunks(steps, chunk),
                     strict=True))
    assert sum(len(t[0]) for _, t in pairs) == steps
    for (jx, jy), (tx, ty) in pairs:
        assert tx.dtype == np.int64 and tx.shape == (len(jx), bs)
        np.testing.assert_array_equal(tx, np.asarray(jx))
        np.testing.assert_array_equal(ty, np.asarray(jy))


def _pair(dim_obs=50, dim_common=32, dim_latent=10, seed=0):
    jm = JaxAE(dim_obs=dim_obs, dim_common=dim_common, dim_latent=dim_latent)
    x = jnp.zeros((1, dim_obs))
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed), x=x, y=x))
    tm = SharedAutoencoder(dim_obs, dim_common, dim_latent)
    tm.load_state_dict(shared_autoencoder_from_jax(params))
    return jm, params, tm


def test_shared_autoencoder_matches_jax():
    jm, params, tm = _pair()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((33, 50)).astype(np.float32)
    y = rng.standard_normal((33, 50)).astype(np.float32)
    want = jm.apply(params, x=jnp.asarray(x), y=jnp.asarray(y))
    got = tm(x=torch.from_numpy(x), y=torch.from_numpy(y))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=AE_TOL,
                                   atol=AE_TOL)
    want = jm.apply(params, x=jnp.asarray(x), y=jnp.asarray(y), method=jm.get_embeddings)
    got = tm.get_embeddings(x=torch.from_numpy(x), y=torch.from_numpy(y))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=AE_TOL,
                                   atol=AE_TOL)
    loss_x, loss_y, recon_x, recon_y = tm(x=torch.from_numpy(x))
    assert loss_y.shape == () and float(loss_y) == 0.0 and recon_y is None
    back = shared_autoencoder_to_jax(tm.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)


def test_init_draws_torch_linear_distribution():
    tm = SharedAutoencoder(50, 64, 10).init_random(torch.Generator().manual_seed(0))
    for name, layer in tm.named_children():
        bound = layer.weight.shape[1] ** -0.5
        for p in (layer.weight, layer.bias):
            assert float(p.abs().max()) <= bound, name
            assert float(p.abs().max()) > 0.8 * bound, name
    again = SharedAutoencoder(50, 64, 10).init_random(torch.Generator().manual_seed(0))
    for a, b in zip(tm.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def _data():
    pool = tdata.generate_data(_cfg(num_samples=800))
    val = tdata.generate_data(_cfg(seed=43, num_samples=300, attenuate_x=False))
    return {"x": pool["x"][:400], "y": pool["y"][400:]}, val


@pytest.mark.parametrize("mode", ["xy", "x"])
def test_train_gaussian_matches_jax(mode):
    pools, val = _data()
    jm, params, _ = _pair()
    init = shared_autoencoder_from_jax(params)
    kw = dict(mode=mode, alpha_x=1.0, alpha_y=0.7, lr=1e-3, batch_size=64,
              num_steps=STEPS, chunk=64)
    want = jtrain.train_gaussian(
        jm, pools, jnp.asarray(val["x"]), jnp.asarray(val["y"]),
        init_params=jax.tree.map(jnp.asarray, params),
        stream=jdata.UnpairedIndexStream(400, 400, 64, seed=42), **kw)
    got = ttrain.train_gaussian(
        ttrain.make_model(50, 32, 10), pools, val["x"], val["y"], init_params=init,
        stream=tdata.UnpairedIndexStream(400, 400, 64, seed=42), device="cpu", **kw)
    assert list(got.history) == list(want.history)
    for key, w in want.history.items():
        g = got.history[key]
        assert g.shape == (STEPS,), key
        if key == "val/mknn":
            np.testing.assert_allclose(g, w, rtol=0, atol=MKNN_ATOL, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, err_msg=key)
    assert got.final_cka == pytest.approx(want.final_cka, rel=LOSS_RTOL)
    assert got.final_val_loss_x == pytest.approx(want.final_val_loss_x, rel=LOSS_RTOL)
    trained = shared_autoencoder_to_jax(got.params)["params"]
    for head in Y_HEADS:
        for leaf in ("kernel", "bias"):
            same_t = np.array_equal(trained[head][leaf], params["params"][head][leaf])
            same_j = np.array_equal(np.asarray(want.params["params"][head][leaf]),
                                    params["params"][head][leaf])
            # mode 'x' never trains the y heads; mode 'xy' does
            assert same_t == same_j == (mode == "x"), (head, leaf)


def test_check_finite_raises_at_the_first_bad_step():
    pools, val = _data()
    pools = {"x": pools["x"].copy(), "y": pools["y"]}
    pools["x"][:] = np.nan
    with pytest.raises(FloatingPointError, match="at step 0"):
        ttrain.train_gaussian(ttrain.make_model(50, 16, 8), pools, val["x"], val["y"],
                              num_steps=10, chunk=4, batch_size=32, device="cpu",
                              check_finite=True)


def _run_cli(monkeypatch, argv, env=None):
    from uml_tpu_torch.cli import gaussian as tcli
    from uml_tpu_torch.core.sweep import run_sweep_cli

    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(sys, "argv", ["gaussian"] + argv)
    run_sweep_cli(tcli.main, tcli.build_parser(), default_config="train.yaml",
                  require_run_flag=True)


def test_cli_sweep_skip_and_results(tmp_path, monkeypatch, capsys):
    from uml_tpu.cli import gaussian as jcli

    monkeypatch.setenv("UML_TORCH_DEVICE", "cpu")
    out = tmp_path / "out"
    config = tmp_path / "small.yaml"
    config.write_text(
        "train_num_samples: [400]\nval_num_samples: [100]\nnum_steps: [12]\n"
        "dim_common: [16]\ndim_latent: [8]\nbatch_size: [32]\n"
        f"mode: ['xy', 'x']\ntag: ['small']\noutdir: ['{out}']\n")
    _run_cli(monkeypatch, ["-c", str(config), "-r", "-s"], {"UML_ARRAY_TASK_ID": "1"})
    x_dir = out / "mode_x-seed_0-tag_small"
    xy_dir = out / "mode_xy-seed_0-tag_small"
    assert (x_dir / "results.json").exists() and not xy_dir.exists()
    first = (x_dir / "results.json").read_text()
    capsys.readouterr()
    _run_cli(monkeypatch, ["-c", str(config), "-r"])
    assert "Skipping" in capsys.readouterr().out
    assert (x_dir / "results.json").read_text() == first
    got = json.loads((xy_dir / "results.json").read_text())
    rows = (xy_dir / "metrics.jsonl").read_text().strip().splitlines()
    assert len(rows) == 12 + 1            # a config header, one row per step

    args = jcli.build_parser().parse_args([
        "--train_num_samples", "400", "--val_num_samples", "100", "--num_steps", "12",
        "--dim_common", "16", "--dim_latent", "8", "--batch_size", "32",
        "--tag", "small", "--outdir", str(tmp_path / "jax")])
    want = jcli.main(args)
    assert list(got) == list(want)
    assert {k: got[k] for k in ("mode", "seed", "num_steps")} == {
        k: want[k] for k in ("mode", "seed", "num_steps")}
    assert all(np.isfinite(got[k]) for k in ("val_loss_x", "val_loss_y", "val_cka",
                                             "val_mknn"))
    jrows = (tmp_path / "jax" / "mode_xy-seed_0-tag_small" / "metrics.jsonl"
             ).read_text().strip().splitlines()
    assert set(json.loads(rows[1])) == set(json.loads(jrows[1]))
