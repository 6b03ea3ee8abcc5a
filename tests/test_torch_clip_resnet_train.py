"""The RN50 / RN101 full-model finetune of the port (BatchNorm in train
form, models/clip_resnet.py; UMLHead.image_features with ``bn_updates`` /
merge_bn_updates; the merge in train/supervised.py) against uml_tpu's on
the CPU.

* ``FrozenBatchNorm``'s train form against uml_tpu's (``mutable=
  ["bn_updates"]``): output and new running statistics within 1e-5.
* A tiny RN CLIP (stages (1, 1, 1, 1), width 8, resolution 32, as
  tests/test_full_finetune.py), its BatchNorm leaves drawn near the
  identity: one fp32 step of the UML loss against ``jax.value_and_grad``
  with ``train_bn=True``, then adamw and ``merge_bn_updates``: the loss,
  every gradient (within 1e-4 of each tensor's largest entry) and the
  running statistics after the step (within 1e-5).
* 40 steps of ``train`` on class-coloured images learn (val acc > 0.6) and
  move every running statistic; the saved snapshot holds them.
* After a step, the eval form reads the new statistics: its cached
  BatchNorm fold is rebuilt (equal to a fresh model's uncached eval).
* The finetune CLI's ``smoke_full`` with a tiny RN50-schema checkpoint.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_data_fewshot import make_caltech_fixture
from tests.test_full_finetune import _image_items
from tests.test_torch_clip_resnet import (RN50_TINY_CKPT, _openai_rn_state_dict,
                                          _redraw_bn)
from uml_tpu.cli import generate_fewshot as gf
from uml_tpu.models import clip as jclip
from uml_tpu.models import clip_resnet as jrn
from uml_tpu.models import uml_head as jhead
from uml_tpu_torch.models import clip as tclip
from uml_tpu_torch.models import clip_resnet as trn
from uml_tpu_torch.models import uml_head as thead
from uml_tpu_torch.models.convert import state_dict_from_jax, uml_head_params_from_jax

TINY_RN = dict(layers=(1, 1, 1, 1), output_dim=16, width=8, image_resolution=32)
TEXT = dict(transformer_width=64, transformer_heads=1, transformer_layers=1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("shape", [(4, 5, 6, 3), (2, 3, 3, 16)])
def test_batch_norm_train_form_matches_uml_tpu(shape):
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)     # NHWC
    params = {"scale": 1 + 0.1 * rng.standard_normal(c),
              "bias": 0.1 * rng.standard_normal(c),
              "mean": 0.1 * rng.standard_normal(c),
              "var": 1 + 0.2 * rng.random(c)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    want, upd = jrn.FrozenBatchNorm(c).apply(
        {"params": params}, jnp.asarray(x), False, mutable=["bn_updates"])
    bn = trn.FrozenBatchNorm(c)
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(params[key]))
    updates = []
    with torch.no_grad():
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2), updates)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    # the buffers move only at the merge
    assert torch.equal(bn.running_mean, torch.from_numpy(params["mean"]))
    (module, mean, var), = updates
    assert module is bn
    trn.merge_bn_updates(updates)
    for got_t, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        np.testing.assert_allclose(got_t.numpy(), np.asarray(upd["bn_updates"][key]),
                                   atol=1e-5, rtol=1e-5)


def _pair(seed=0):
    """uml_tpu's tiny RN CLIP and UMLClip head, and the port's with the
    same parameters."""
    rn = jrn.ClipResNetConfig(**TINY_RN)
    text = jclip.ClipConfig(embed_dim=16, image_resolution=32, vision_layers=0,
                            vision_width=8, vision_patch_size=0, **TEXT)
    jmodel = jclip.ClipResNetModel(rn, text, dtype=jnp.float32, attn_impl="reference")
    v = jax.jit(jmodel.init)(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 77), jnp.int32))
    v = {"params": _redraw_bn(_np(v["params"]), np.random.default_rng(seed))}
    jh = jhead.make_uml_clip_head(jmodel, v, 3, logit_scale=0.0, freeze_backbone=False)
    params = jh.init_params(seed=0)
    port = tclip.ClipResNetModel(trn.ClipResNetConfig(**TINY_RN),
                                 tclip.ClipConfig(**vars(text)), dtype=torch.float32)
    th = thead.make_uml_clip_head(port, 3, logit_scale=0.0, freeze_backbone=False)
    th.load_state_tree(uml_head_params_from_jax(_np(params)))
    return jh, params, th


def _batch(seed=1, n=6):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 32 * 32 * 3), dtype=np.uint8),
            rng.integers(0, 3, n))


def test_one_step_matches_jax_value_and_grad():
    jh, params, th = _pair()
    imgs, lab = _batch()

    def loss_fn(p):
        feats, upd = jh.image_features_train(p, jnp.asarray(imgs))
        logits = feats @ p["head_w"]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(lab)).mean(), upd

    (jloss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    opt = optax.adamw(1e-3, weight_decay=0.0)
    updates, _ = opt.update(grads, opt.init(params), params)
    jnew = jh.merge_bn_updates(optax.apply_updates(params, updates), upd)

    bn_updates = []
    feats = th.image_features(torch.from_numpy(imgs), bn_updates)
    assert len(bn_updates) == 3 + 4 * 4        # the stem, 3 per block + downsample
    loss = torch.nn.functional.cross_entropy(feats @ th.head_w, torch.from_numpy(lab))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = uml_head_params_from_jax(_np(grads))
    params_t = dict(th.named_parameters())
    reached = 0
    for key, w in list(want["backbone"].items()) + [("head_w", want["head_w"])]:
        name = key if key == "head_w" else f"backbone.{key}"
        if key.endswith(("running_mean", "running_var")):
            assert name not in params_t             # buffers, not parameters
            assert w.abs().max().item() == 0.0      # no gradient reaches them
            continue
        g = params_t[name].grad
        if g is None:      # the text tower and logit_scale: not reached
            assert w.abs().max().item() == 0.0, key
            continue
        reached += 1
        if key.endswith("attnpool.k_proj.bias"):
            continue       # an exact zero gradient (the softmax cancels it)
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item(), key
    assert reached == len([k for k in want["backbone"] if k.startswith("visual.")
                           and "running" not in k]) + 1
    torch.optim.AdamW([p for p in th.parameters() if p.grad is not None],
                      lr=1e-3, weight_decay=0.0).step()
    th.merge_bn_updates(bn_updates)
    want_sd = state_dict_from_jax(_np(jnew["backbone"]))
    got_sd = th.backbone.state_dict()
    stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 19
    for key in stats:
        torch.testing.assert_close(got_sd[key], want_sd[key], atol=1e-5, rtol=1e-5)
    moved = max((got_sd[k] - state_dict_from_jax(_np(params["backbone"]))[k])
                .abs().max().item() for k in stats)
    assert moved > 1e-3


def _items_and_val(tmp_path):
    from uml_tpu_torch.data.loader import ImageBatchLoader
    from uml_tpu_torch.train.supervised import eval_batches

    items = _image_items(tmp_path)
    imgs, labels = [], []
    for im, lab, _ in ImageBatchLoader(items, "crop", 8, size=(32, 32)):
        imgs.append(im.reshape(im.shape[0], -1))
        labels.append(lab)
    return items, eval_batches(np.concatenate(imgs), np.concatenate(labels), 8)


def _bn_stats(model):
    return {k: v.clone() for k, v in model.backbone.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.mark.heavy
def test_rn_full_finetune_learns_and_moves_the_statistics(tmp_path):
    """tests/test_full_finetune.py::test_resnet_bn_training_full_finetune
    in the port: 40 steps, the statistics move by the merge alone."""
    from uml_tpu_torch.data.loader import RawImageStream
    from uml_tpu_torch.train.optim import build_optimizer, build_schedule
    from uml_tpu_torch.train.supervised import train

    _, _, th = _pair()
    before = _bn_stats(th)
    items, val = _items_and_val(tmp_path)
    stream = RawImageStream(items, "crop", batch_size=8, seed=0, num_workers=2,
                            size=(32, 32))
    opt = build_optimizer("adamw", build_schedule(1e-3, "cosine", 0, 40), 0.0)
    out = train(th, stream, None, val, optimizer=opt, max_iters=40,
                eval_freq=20, patience=10)
    assert out["val_acc"] > 0.6
    after = out["model"]["backbone"]
    for key, b in before.items():
        a = torch.as_tensor(after[key])
        assert torch.isfinite(a).all() and not torch.allclose(a, b), key
        if key.endswith("running_var"):
            assert (a > 0).all(), key
    # no running statistic entered the optimizer
    bound = {id(p) for g in opt.torch_optimizer.param_groups for p in g["params"]}
    assert not any(id(b) in bound for b in th.backbone.buffers())


def test_eval_after_a_step_reads_the_new_statistics():
    """The eval form's BatchNorm fold is cached on the tensors' version
    counters: after the optimizer step and the merge it is rebuilt, so the
    eval equals a fresh model's (no cache) with the same state."""
    _, _, th = _pair()
    imgs, lab = _batch(n=4)
    x = torch.from_numpy(imgs)
    with torch.no_grad():
        first = th.image_features(x)
    conv = th.backbone.visual.conv1
    folded = conv._folded._value
    upd = []
    feats = th.image_features(x, upd)
    torch.nn.functional.cross_entropy(feats @ th.head_w, torch.from_numpy(lab)).backward()
    torch.optim.AdamW([p for p in th.parameters() if p.grad is not None],
                      lr=1e-2).step()
    th.merge_bn_updates(upd)
    with torch.no_grad():
        second = th.image_features(x)
    assert conv._folded._value is not folded
    assert not torch.allclose(first, second)
    fresh = tclip.ClipResNetModel(th.backbone.resnet_config, th.backbone.config,
                                  dtype=torch.float32)
    fresh.load_state_dict(th.backbone.state_dict())
    with torch.no_grad():
        want = fresh.encode_image_u8(x)
    torch.testing.assert_close(second, want, atol=0, rtol=0)


@pytest.mark.heavy
def test_finetune_cli_rn_smoke_full(tmp_path, monkeypatch):
    """``finetune --clip-encoder RN50 --hyperparams smoke_full`` on a tiny
    RN50-schema checkpoint (stages (1, 1, 1, 1), width 16, RN50's output
    width): the saved model holds the trained tower, every running
    statistic moved (one step and its merge before the iter-0 eval) and
    is finite, the variances positive."""
    from uml_tpu_torch.cli import features as torch_features
    from uml_tpu_torch.cli import finetune as torch_ft
    from uml_tpu_torch.data.feature_cache import load_cache

    root = make_caltech_fixture(str(tmp_path / "data"))
    weights = tmp_path / "weights"
    weights.mkdir()
    sd = _openai_rn_state_dict(RN50_TINY_CKPT, 5)
    torch.save(sd, str(weights / "RN50.pt"))
    monkeypatch.setenv("UML_CLIP_WEIGHTS_DIR", str(weights))
    monkeypatch.setenv("UML_CLIP_VERIFY_SHA", "0")
    monkeypatch.setenv("UML_TORCH_DEVICE", "cpu")
    gf.main(gf.build_parser().parse_args([
        "--data_dir", root, "--indices_dir", f"{root}/indices",
        "--dataset", "caltech101", "--train-shot", "2", "--seed", "1"]))
    common = ["--data_dir", root, "--indices_dir", f"{root}/indices",
              "--dataset", "caltech101", "--train-shot", "2", "--seed", "1",
              "--feature_dir", str(tmp_path / "features"), "--mesh", "off"]
    args = torch_features.build_parser().parse_args(common + [
        "--text-augmentation", "hand_crafted", "--batch-size", "8",
        "--num-workers", "1"])
    args.overwrite, args.force_rerun = False, False
    torch_features.main(args)
    exp = str(tmp_path / "experiments")
    args = torch_ft.build_parser().parse_args(common + [
        "--result_dir", exp, "--text_type", "hand_crafted", "--modality",
        "crossmodal", "--alpha", "0.5", "--hyperparams", "smoke_full"])
    assert args.clip_encoder == "RN50"
    args.overwrite, args.force_rerun = False, False
    torch_ft.main(args)
    (path,) = [os.path.join(d, f) for d, _, files in os.walk(exp) for f in files
               if f == "test_result.pth"]
    result = load_cache(path)
    assert np.isfinite(result["test_acc"]) and np.isfinite(result["val_acc"])
    assert set(result["model"]) == {"head_w", "backbone"}
    trained = result["model"]["backbone"]
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))
             and k.startswith("visual.")]
    assert len(stats) == 2 * 19
    for key in stats:
        t = torch.as_tensor(trained[key])
        assert torch.isfinite(t).all() and not torch.equal(t, sd[key]), key
        if key.endswith("running_var"):
            assert (t > 0).all(), key
    assert not torch.equal(torch.as_tensor(trained["visual.conv1.weight"]),
                           sd["visual.conv1.weight"])
