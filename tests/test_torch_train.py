"""The supervised training path of uml_tpu_torch against uml_tpu's (CPU).

* Pieces: the batch streams (CyclicBatcher, eval_batches, RawImageStream)
  give the same batches as uml_tpu's from the same seeds; the schedules
  and optimizers give the same learning rates and updates as optax; the
  alignment metrics agree with the JAX ones (on tie-free, continuous
  random inputs: ``torch.topk`` and ``jax.lax.top_k`` may order ties
  differently); the head's zero-shot init is the same.
* The loop: ``train()`` of both packages on seeded synthetic features
  (the protocol of PARITY.md section 3): ragged batches on both streams,
  ``img_proj`` and learnable scales on, the capture set on, 40
  iterations with an eval every 10.  Every logged metric of every step
  agrees within rtol 1e-5 (atol 1e-5 for the cosines, rates and scores in
  [-1, 1], which pass near zero), fp32; the best iteration and the
  early-stop iteration are equal.
* The full model: a tiny fp32 CLIP (width 128, 2 heads, 2 layers, 64 px,
  patch 16) with the JAX weights carried across by models/convert.py, a
  RawImageStream over a JPEG fixture, a text stream, 10 adamw steps with
  weight decay, in each backward mode of the port: the default (the
  stash backwards), and with both stashes off under UML_MLP_BWD=kernel
  and =dw (the plain versions of the recompute backwards #7, #19, #20;
  uml_tpu on the CPU takes its plain VJP in every mode).  Per-step losses agree within rtol 1e-4; every parameter
  tensor of the CLIP after the 10 steps (the unused text tower included,
  which only decays) within 1e-4 of its largest entry.  The attention
  k-biases are the exception: their exact gradient is zero, so adam
  normalizes rounding noise into steps of either sign, and only the size
  of their change is bounded.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from uml_tpu.data import loader as jax_loader
from uml_tpu.metrics import alignment as jal
from uml_tpu.models.clip import CLIP as JaxCLIP
from uml_tpu.models.clip import ClipConfig as JaxConfig
from uml_tpu.models import uml_head as jhead
from uml_tpu.train import optim as joptim
from uml_tpu.train import supervised as jsup
from uml_tpu_torch.data import loader as torch_loader
from uml_tpu_torch.metrics import alignment as tal
from uml_tpu_torch.models.clip import CLIP, ClipConfig
from uml_tpu_torch.models import uml_head as thead
from uml_tpu_torch.models.convert import state_dict_from_jax, uml_head_params_from_jax
from uml_tpu_torch.ops import fused_attention as tfa
from uml_tpu_torch.ops import ln_matmul as tlm
from uml_tpu_torch.train import optim as toptim
from uml_tpu_torch.train import supervised as tsup

LOOP_RTOL = 1e-5
# cosines / agreement rates / alignment scores live in [-1, 1] and pass
# near zero, where a relative bound means nothing: 1e-5 of their range
SIM_ATOL = 1e-5
SIM_KEYS = ("sim", "rate", "score")
FULL_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class ListLogger:
    def __init__(self):
        self.rows = []

    def log(self, metrics):
        self.rows.append(dict(metrics))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- pieces --------------------------------------------------------------


def test_cyclic_batcher_and_eval_batches_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((23, 5)).astype(np.float32)
    y = rng.integers(0, 4, 23)
    jt, tt = iter(jsup.CyclicBatcher(x, y, 8, seed=3)), iter(tsup.CyclicBatcher(x, y, 8, seed=3))
    for _ in range(10):
        for a, b in zip(next(jt), next(tt)):
            np.testing.assert_array_equal(a, b)
    skipped = tsup.CyclicBatcher(x, y, 8, seed=3).skip(7)
    replay = iter(jsup.CyclicBatcher(x, y, 8, seed=3))
    for _ in range(7):
        next(replay)
    for a, b in zip(next(replay), next(skipped)):
        np.testing.assert_array_equal(a, b)
    for jb, tb in zip(jsup.eval_batches(x, y, 8), tsup.eval_batches(x, y, 8),
                      strict=True):
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(a, b)


def _image_items(root, n_classes=3, per_class=8, size=32):
    """Class-coloured JPEGs (the fixture of tests/test_full_finetune.py)."""
    items = []
    rng = np.random.default_rng(0)
    for c in range(n_classes):
        for i in range(per_class):
            arr = np.zeros((size, size, 3), np.uint8)
            arr[..., c] = rng.integers(150, 255)
            arr += rng.integers(0, 40, arr.shape, dtype=np.uint8)
            p = os.path.join(root, f"c{c}_{i}.jpg")
            Image.fromarray(arr).save(p, quality=95)
            items.append({"impath": p, "label": c, "classname": str(c)})
    return items


@pytest.fixture
def pil_only(monkeypatch):
    """uml_tpu decodes with PIL, as the port does (its native decoder off)."""
    import uml_tpu.native

    monkeypatch.setattr(uml_tpu.native, "native_available", lambda: False)


@pytest.mark.parametrize("augmentation", ["crop", "flip"])
def test_raw_image_stream_matches(tmp_path, pil_only, augmentation):
    items = _image_items(str(tmp_path))
    kw = dict(batch_size=7, seed=2, num_workers=2, size=(32, 32))
    js = iter(jax_loader.RawImageStream(items, augmentation, **kw))
    ts = iter(torch_loader.RawImageStream(items, augmentation, **kw))
    for _ in range(9):   # 24 items, bs 7: ragged epochs, three epochs
        for a, b in zip(next(js), next(ts)):
            np.testing.assert_array_equal(a, b)
    skipped = torch_loader.RawImageStream(items, augmentation, **kw).skip(5)
    replay = iter(torch_loader.RawImageStream(items, augmentation, **kw))
    for _ in range(5):
        next(replay)
    for a, b in zip(next(replay), next(skipped)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sched,warmup_type", [("cosine", "linear"),
                                               ("linear", "constant"),
                                               ("cosine", None)])
def test_schedule_matches(sched, warmup_type):
    warm = 0 if warmup_type is None else 5
    js = joptim.build_schedule(1e-3, sched, warm, 40, warmup_type or "linear", 1e-5)
    ts = toptim.build_schedule(1e-3, sched, warm, 40, warmup_type or "linear", 1e-5)
    for step in range(45):
        # uml_tpu evaluates the schedule in fp32: rtol 1e-5, and one fp32
        # ulp of lr near the end of the cosine
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-5,
                                   atol=1e-3 * 2.0 ** -23)
    assert ts(0) == (1e-5 if warm else 1e-3)   # absolute warmup_min_lr


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_optimizer_updates_match_optax(name):
    """Six updates of two parameters (one the loss does not reach) with
    weight decay on a warmup+cosine schedule."""
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    u0 = rng.standard_normal(3).astype(np.float32)
    grads = rng.standard_normal((6, 4, 3)).astype(np.float32)
    sched_args = (1e-2, "cosine", 2, 6, "linear", 1e-3)

    opt = joptim.build_optimizer(name, joptim.build_schedule(*sched_args), 0.1)
    params = {"w": jnp.asarray(w0), "u": jnp.asarray(u0)}
    state = opt.init(params)
    for g in grads:
        upd, state = opt.update({"w": jnp.asarray(g), "u": jnp.zeros(3)},
                                state, params)
        params = optax.apply_updates(params, upd)

    w = torch.nn.Parameter(torch.tensor(w0))
    u = torch.nn.Parameter(torch.tensor(u0))
    topt = toptim.build_optimizer(name, toptim.build_schedule(*sched_args), 0.1)
    topt.init([w, u])
    for i, g in enumerate(grads):
        topt.zero_grad()
        w.grad.copy_(torch.tensor(g))
        topt.step(i)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(u.detach().numpy(), np.asarray(params["u"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,d,topk", [(24, 16, 5), (40, 8, 10)])
def test_alignment_metrics_match(n, d, topk):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, d)).astype(np.float32)
    b = rng.standard_normal((n, d + 3)).astype(np.float32)
    ta, tb = torch.tensor(a), torch.tensor(b)
    np.testing.assert_array_equal(
        tal.compute_nearest_neighbors(ta, topk).numpy(),
        np.asarray(jal.compute_nearest_neighbors(jnp.asarray(a), topk)))
    np.testing.assert_allclose(float(tal.mutual_knn(ta, tb, topk)),
                               float(jal.mutual_knn(jnp.asarray(a), jnp.asarray(b), topk)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tal.cka(ta, tb)),
                               float(jal.cka(jnp.asarray(a), jnp.asarray(b), "ip")),
                               rtol=1e-5)
    k, l_ = a @ a.T, b @ b.T
    np.testing.assert_allclose(float(tal.hsic_biased(torch.tensor(k), torch.tensor(l_))),
                               float(jal.hsic_biased(jnp.asarray(k), jnp.asarray(l_))),
                               rtol=1e-5)


def test_zero_shot_init_and_scales_match():
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((20, 8)).astype(np.float32)
    labels = rng.integers(0, 5, 20)
    jm = jhead.UMLHead(feat_dim=8, num_classes=5, logit_scale=2.0)
    jp = jm.zero_shot_init(jm.init_params(), feats, labels)
    tm = thead.UMLHead(8, 5, logit_scale=2.0)
    tm.zero_shot_init(feats, labels)
    np.testing.assert_allclose(tm.head_w.detach().numpy(), np.asarray(jp["head_w"]),
                               rtol=1e-6)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    got = tm(torch.tensor(x), torch.tensor(x))
    want = jm.forward(jp, jnp.asarray(x), jnp.asarray(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5)


# -- the loop on features --------------------------------------------------


def _features(n_per_class, n_classes, dim, seed, centers):
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(n_classes), n_per_class)
    feats = centers[labels] + rng.standard_normal((len(labels), dim))
    return feats.astype(np.float32), labels.astype(np.int64)


@pytest.mark.parametrize("eval_freq,stops_at", [(10, 40), (4, 20)])
def test_train_loop_matches_jax(eval_freq, stops_at):
    """40 iterations, patience 2: evals every 10 run to the end (best at
    30); evals every 4 stop early at 20 (best at 12)."""
    n_classes, img_dim, txt_dim = 6, 16, 8
    rng = np.random.default_rng(0)
    # overlapping classes keep the losses O(1): near zero a CE's relative
    # error means nothing
    img_centers = rng.standard_normal((n_classes, img_dim)) * 0.5
    txt_centers = rng.standard_normal((n_classes, txt_dim)) * 0.5
    img, img_lab = _features(9, n_classes, img_dim, 1, img_centers)   # 54: ragged at bs 16
    txt, txt_lab = _features(6, n_classes, txt_dim, 2, txt_centers)   # 36: ragged
    val, val_lab = _features(4, n_classes, img_dim, 3, img_centers)
    capture = {"image_feats": img[:24], "image_labels": img_lab[:24],
               "text_feats": txt[:24]}
    sched = (0.01, "cosine", 5, 40, "linear", 1e-4)
    kw = dict(max_iters=40, alpha=0.7, img_alpha=1.0, eval_freq=eval_freq,
              patience=2, capture=capture)

    jm = jhead.UMLHead(feat_dim=img_dim, num_classes=n_classes, text_indim=txt_dim,
                       learnable_temp=True)
    params = jm.init_params(seed=0)
    init = uml_head_params_from_jax(_np_tree(params))  # jax donates params
    jlog = ListLogger()
    jout = jsup.train(
        jm, jsup.CyclicBatcher(img, img_lab, 16, seed=0),
        jsup.CyclicBatcher(txt, txt_lab, 16, seed=1),
        jsup.eval_batches(val, val_lab, 16),
        optimizer=joptim.build_optimizer("adamw", joptim.build_schedule(*sched), 1e-4),
        logger=jlog, init_params=params, **kw)

    tm = thead.UMLHead(img_dim, n_classes, text_indim=txt_dim, learnable_temp=True)
    tlog = ListLogger()
    tout = tsup.train(
        tm, tsup.CyclicBatcher(img, img_lab, 16, seed=0),
        tsup.CyclicBatcher(txt, txt_lab, 16, seed=1),
        tsup.eval_batches(val, val_lab, 16),
        optimizer=toptim.build_optimizer("adamw", toptim.build_schedule(*sched), 1e-4),
        logger=tlog, init_params=init, **kw)

    assert len(tlog.rows) == len(jlog.rows)
    for step, (t, j) in enumerate(zip(tlog.rows, jlog.rows)):
        assert set(t) == set(j), step   # jit returns jax's dict sorted
        for key in j:
            atol = SIM_ATOL if key.endswith(SIM_KEYS) else 0.0
            np.testing.assert_allclose(t[key], j[key], rtol=LOOP_RTOL,
                                       atol=atol, err_msg=f"{step} {key}")
    assert "train/cka_score" in jlog.rows[0] and "train/mknn_score" in jlog.rows[0]
    assert tout["iter"] == jout["iter"]
    assert tout["stopped_at"] == jout["stopped_at"] == stops_at
    assert tout["val_acc"] == pytest.approx(jout["val_acc"], rel=LOOP_RTOL)
    for name, leaf in jout["model"].items():
        leaf = np.asarray(leaf)   # best snapshot: within 1e-5 of its max
        np.testing.assert_allclose(tout["model"][name].numpy(), leaf, rtol=0,
                                   atol=LOOP_RTOL * np.abs(leaf).max(),
                                   err_msg=name)


# -- the full model ----------------------------------------------------------

TINY = dict(embed_dim=64, image_resolution=64, vision_layers=2,
            vision_width=128, vision_patch_size=16, transformer_width=128,
            transformer_heads=2, transformer_layers=2)


class RisingValidate:
    """A validate_fn whose accuracy rises at every call, so every eval is
    a new best and the returned snapshot is the last step's parameters."""

    def __init__(self):
        self.calls = 0

    def __call__(self, params, batches):
        self.calls += 1
        return 1.0, float(self.calls)


RECOMPUTE = {"UML_BWD_STASH": "0", "UML_MLP_STASH": "0"}
# environment of each backward mode -> the backward ops it must run
BWD_MODES = {
    "default": ({}, ("attn_block_bwd", "mlp_bwd_via_stash")),
    "recompute_kernel": ({**RECOMPUTE, "UML_MLP_BWD": "kernel"},
                         ("attn_block_bwd_recompute", "mlp_bwd")),
    "recompute_dw": ({**RECOMPUTE, "UML_MLP_BWD": "dw"},
                     ("attn_block_bwd_recompute", "mlp_bwd_dw")),
}


def _spy_backwards(monkeypatch):
    """Count the calls of the backward ops the autograd Functions pick."""
    calls = {}
    for module, name in ((tfa, "attn_block_bwd"), (tfa, "attn_block_bwd_recompute"),
                         (tlm, "mlp_bwd_via_stash"), (tlm, "mlp_bwd"),
                         (tlm, "mlp_bwd_dw")):
        calls[name] = 0

        def counted(*args, _fn=getattr(module, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.heavy
@pytest.mark.parametrize("mode", list(BWD_MODES))
def test_full_model_steps_match_jax(tmp_path, pil_only, monkeypatch, mode):
    env, want_ops = BWD_MODES[mode]
    for var in ("UML_BWD_STASH", "UML_MLP_STASH", "UML_MLP_BWD"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    calls = _spy_backwards(monkeypatch)
    items = _image_items(str(tmp_path), per_class=6, size=80)   # 18 items
    rng = np.random.default_rng(5)
    txt = rng.standard_normal((10, TINY["embed_dim"])).astype(np.float32)
    txt_lab = rng.integers(0, 3, 10).astype(np.int64)
    sched = (1e-4, "cosine", 2, 10, "linear", 1e-5)
    kw = dict(max_iters=10, alpha=0.5, eval_freq=1, patience=100)

    jclip = JaxCLIP(JaxConfig(**TINY), dtype=jnp.float32)
    variables = _np_tree(jax.jit(jclip.init)(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3), jnp.float32),
        jnp.zeros((1, 77), jnp.int32)))
    jm = jhead.make_uml_clip_head(jclip, variables, 3, logit_scale=1.0,
                                  freeze_backbone=False)
    params = jm.zero_shot_init(jm.init_params(seed=0), txt, txt_lab)
    init = uml_head_params_from_jax(_np_tree(params))  # jax donates params
    jlog = ListLogger()
    jout = jsup.train(
        jm, jax_loader.RawImageStream(items, "crop", 8, seed=0, num_workers=2,
                                      size=(64, 64)),
        jsup.CyclicBatcher(txt, txt_lab, 8, seed=1), [None],
        optimizer=joptim.build_optimizer("adamw", joptim.build_schedule(*sched), 0.01),
        logger=jlog, validate_fn=RisingValidate(), init_params=params, **kw)

    clip = CLIP(ClipConfig(**TINY), dtype=torch.float32)
    tm = thead.make_uml_clip_head(clip, 3, logit_scale=1.0, freeze_backbone=False)
    tlog = ListLogger()
    tout = tsup.train(
        tm, torch_loader.RawImageStream(items, "crop", 8, seed=0, num_workers=2,
                                        size=(64, 64)),
        tsup.CyclicBatcher(txt, txt_lab, 8, seed=1), [None],
        optimizer=toptim.build_optimizer("adamw", toptim.build_schedule(*sched), 0.01),
        logger=tlog, validate_fn=RisingValidate(), init_params=init, **kw)

    losses = [(t["train/image_loss"], j["train/image_loss"])
              for t, j in zip(tlog.rows, jlog.rows) if "train/image_loss" in j]
    assert len(losses) == 10
    np.testing.assert_allclose(*zip(*losses), rtol=FULL_RTOL)
    assert tout["iter"] == jout["iter"] == 9
    want = state_dict_from_jax(_np_tree(jout["model"]["backbone"]))
    got = tout["model"]["backbone"]
    init = state_dict_from_jax(variables)
    assert set(got) == set(want)
    moved = 0.0
    for key, w in want.items():
        g = got[key]
        if key.endswith("attn.in_proj_bias"):
            # the k-bias has an exact zero gradient (the softmax cancels
            # it), so adam turns each package's fp32 rounding noise into
            # lr-sized steps of either sign: only their size is held
            q, k, v = w.chunk(3)
            gq, gk, gv = g.chunk(3)
            assert (gk - k).abs().max().item() <= 4 * 10 * sched[0], key
            w, g = torch.cat([q, v]), torch.cat([gq, gv])
        err = (g - w).abs().max().item()
        assert err <= FULL_RTOL * w.abs().max().item(), (key, err)
        moved = max(moved, (want[key] - init[key]).abs().max().item())
    assert moved > 1e-4   # the tower trained
    np.testing.assert_allclose(tout["model"]["head_w"].numpy(),
                               np.asarray(jout["model"]["head_w"]), rtol=FULL_RTOL,
                               atol=FULL_RTOL)
    # 10 steps of 1 full layer (+ the CLS layer's own backward) and 2 MLPs
    assert calls == {name: {"attn_block_bwd": 10, "attn_block_bwd_recompute": 10,
                            "mlp_bwd_via_stash": 20, "mlp_bwd": 20,
                            "mlp_bwd_dw": 20}[name] * (name in want_ops)
                     for name in calls}, calls



# CLIP ViT-L/14 at its published widths (image tower 1024 wide, 16 heads,
# patch 14 at 224 px: S = 257; text tower 768 wide, 12 heads), cut to two
# layers a tower: a sequence length the port's kernels refused before they
# streamed K/V
VIT_L14_DEPTH2 = dict(embed_dim=768, image_resolution=224, vision_layers=2,
                      vision_width=1024, vision_patch_size=14,
                      transformer_width=768, transformer_heads=12,
                      transformer_layers=2)
# per parameter tensor: max |port - JAX| of the gradient <= 1e-3 of the JAX
# gradient's largest entry (fp32 both; the packages sum in other orders)
VIT_L14_GRAD_RTOL = 1e-3


def _vit_l14_batch():
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (2, 224 * 224 * 3), dtype=np.uint8)
    return img, np.array([0, 2], np.int64), np.ones(2, np.float32)


@functools.lru_cache(maxsize=1)
def _vit_l14_jax_grads():
    """(head params as numpy, the image loss, its gradient by jax.grad)."""
    jclip = JaxCLIP(JaxConfig(**VIT_L14_DEPTH2), dtype=jnp.float32)
    variables = _np_tree(jax.jit(jclip.init)(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3), jnp.float32),
        jnp.zeros((1, 77), jnp.int32)))
    jm = jhead.make_uml_clip_head(jclip, variables, 3, logit_scale=1.0,
                                  freeze_backbone=False)
    rng = np.random.default_rng(5)
    txt = rng.standard_normal((10, 768)).astype(np.float32)
    params = jm.zero_shot_init(jm.init_params(seed=0), txt,
                               rng.integers(0, 3, 10).astype(np.int64))
    img, lab, w = _vit_l14_batch()

    def loss_fn(p):
        feats, _ = jm.image_features_train(p, jnp.asarray(img))
        return jsup._weighted_ce(feats @ p["head_w"] * jm._scales(p)[0],
                                 jnp.asarray(lab), jnp.asarray(w))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return _np_tree(params), float(loss), _np_tree(grads)


@pytest.mark.heavy
@pytest.mark.parametrize("mode", list(BWD_MODES))
def test_vit_l14_full_model_gradients_match_jax(monkeypatch, mode):
    """One forward and backward of the image loss through the depth-2,
    full-width ViT-L/14 in fp32, port against JAX, in each backward mode
    (the plain versions of the stash rows 5, 6, 8, 9, or of the recompute
    rows 7, 19, 20, at S = 257): the loss within rtol 1e-5, every
    parameter gradient of the image tower and the head within
    VIT_L14_GRAD_RTOL (the k-biases aside: their exact gradient is zero)."""
    env, want_ops = BWD_MODES[mode]
    for var in ("UML_BWD_STASH", "UML_MLP_STASH", "UML_MLP_BWD"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    calls = _spy_backwards(monkeypatch)
    params, jloss, jgrads = _vit_l14_jax_grads()
    clip = CLIP(ClipConfig(**VIT_L14_DEPTH2), dtype=torch.float32)
    tm = thead.make_uml_clip_head(clip, 3, logit_scale=1.0, freeze_backbone=False)
    tm.load_state_tree(uml_head_params_from_jax(params))
    img, lab, w = _vit_l14_batch()
    loss = tsup.weighted_ce(
        tm.image_features(torch.from_numpy(img)) @ tm.head_w * tm.scales()[0],
        torch.from_numpy(lab), torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    want = state_dict_from_jax(jgrads["backbone"])
    got = {k: p.grad for k, p in tm.backbone.named_parameters()
           if k.startswith("visual.")}
    assert got and all(g is not None for g in got.values())
    for key, g in got.items():
        wg = want[key]
        if key.endswith("attn.in_proj_bias"):
            wg, g = torch.cat([wg.chunk(3)[0], wg.chunk(3)[2]]), torch.cat(
                [g.chunk(3)[0], g.chunk(3)[2]])
        err = (g - wg).abs().max().item()
        assert err <= VIT_L14_GRAD_RTOL * wg.abs().max().item(), (key, err)
    np.testing.assert_allclose(tm.head_w.grad.numpy(), jgrads["head_w"],
                               rtol=VIT_L14_GRAD_RTOL,
                               atol=VIT_L14_GRAD_RTOL * np.abs(jgrads["head_w"]).max())
    # 1 full layer (+ the CLS layer's own backward) and 2 MLPs
    assert calls == {name: {"attn_block_bwd": 1, "attn_block_bwd_recompute": 1,
                            "mlp_bwd_via_stash": 2, "mlp_bwd": 2,
                            "mlp_bwd_dw": 2}[name] * (name in want_ops)
                     for name in calls}, calls
