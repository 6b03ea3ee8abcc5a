"""The port's data parallelism against uml_tpu's data mesh, on the CPU.

uml_tpu runs its loops over ``create_mesh(n_data=2)`` on two of the eight
virtual CPU devices (tests/conftest.py); the port runs the same loops in
two processes joined over gloo, each keeping its rows of every global
batch.  Both compute the global batch's math, so they must agree:

* ``detect_topology`` equals uml_tpu's on the same environments;
  ``maybe_shard_batch`` keeps each rank's contiguous rows, and a batch
  that does not divide stays whole; ``--mesh auto`` on a CLI's command
  line with two cards starts two processes, which join as one group, and
  exits with the worst exit code; a Python call of ``mesh_from_flag`` or
  of a CLI's ``main`` starts none;
* the frozen-head ``train`` with a ragged last image batch (one rank's
  rows are all padding) and a text batch of 15 (kept whole on each rank):
  every logged metric within 1e-5 relative (the similarities 1e-5
  absolute), the same best iteration, early stop and validation accuracy,
  the snapshot within 1e-5 of each tensor's largest entry;
* the tiny RN CLIP's full-model steps with BatchNorm in its train form (a
  global batch of 8 with 2 padding rows), by SGD (Adam would scale the
  rounding of near-zero gradients up to lr a step): the logged losses
  within 1e-4, every parameter within 1e-4 of its largest entry (the
  attention pool's key bias, whose gradient the softmax cancels, below
  1e-8) and the running statistics within 1e-5;
* ``train_selfsup`` with the masked MSE and with InfoNCE, dropout off (a
  last batch of 3 stays whole), at the CLI's lr 1e-4: every logged metric
  within 3e-4 (the effective rank, an SVD, and loss_private, a sum of
  squared means of products, 1e-3: a one-process run of the port drifts
  from uml_tpu's as far over these six InfoNCE steps), the probe scores
  within 0.02, every parameter within one lr step of uml_tpu's and each
  tensor's update (its change from the init) within 1% of uml_tpu's in
  norm (qkv's key bias, rounding noise that Adam scales up to lr a step,
  within 5 lr a step);
* with dropout on, the 2-rank run's probe scores within 0.02 of the
  1-rank run's (uml_tpu's tests/test_cli_dp.py holds its mesh so): every
  rank draws the global batch's masks, so the masks are the 1-rank run's;
* the differentiable all-gather and all-reduce against autograd on the
  gathered tensor;
* a 2-rank ``features`` run writes the caches of a 1-rank run, bit for
  bit (each rank encodes whole loader batches), the ranks started with
  different hash seeds, so each iterates the dataset's class set in an
  order of its own.

The two ranks meet through a ``file://`` store under the test's own
directory and are joined with a timeout, so a hang fails the test.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD = 2
JOIN_TIMEOUT = 300
LOOP_RTOL = 1e-5
SIM_ATOL = 1e-5
SIM_KEYS = ("sim", "rate", "score")
RN_RTOL = 1e-4
RN_LR = 0.1
RN_STEPS = 2
SELFSUP_UPDATE_RTOL = 1e-2
SELFSUP_METRIC_RTOL = 3e-4
RANK_RTOL = 1e-3
SCORE_ATOL = 0.02
SELFSUP_LR = 1e-4
TINY_RN = dict(layers=(1, 1, 1, 1), output_dim=16, width=8, image_resolution=32)
RN_TEXT = dict(embed_dim=16, image_resolution=32, vision_layers=0, vision_width=8,
               vision_patch_size=0, transformer_width=64, transformer_heads=1,
               transformer_layers=1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ListLogger:
    def __init__(self):
        self.rows = []

    def log(self, metrics):
        self.rows.append(dict(metrics))


class RisingValidate:
    """Accuracy rises at every call: every eval is a new best."""

    def __init__(self):
        self.calls = 0

    def __call__(self, params, batches):
        self.calls += 1
        return 1.0, float(self.calls)


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


# -- the port's side, run by each rank ---------------------------------------


def _port_frozen(mesh, job):
    from uml_tpu_torch.models import uml_head as thead
    from uml_tpu_torch.train import optim as toptim
    from uml_tpu_torch.train import supervised as tsup

    tm = thead.UMLHead(job["img"].shape[1], job["n_classes"],
                       text_indim=job["txt"].shape[1], learnable_temp=True)
    log = ListLogger()
    out = tsup.train(
        tm, tsup.CyclicBatcher(job["img"], job["img_lab"], job["img_bs"], seed=0),
        tsup.CyclicBatcher(job["txt"], job["txt_lab"], job["txt_bs"], seed=1),
        tsup.eval_batches(job["val"], job["val_lab"], job["img_bs"]),
        optimizer=toptim.build_optimizer("adamw", toptim.build_schedule(*job["sched"]),
                                         1e-4),
        logger=log, init_params=job["init"], mesh=mesh, **job["kw"])
    return {"rows": log.rows, "iter": out["iter"], "val_acc": out["val_acc"],
            "stopped_at": out["stopped_at"],
            "model": {k: v.numpy() for k, v in out["model"].items()}}


def _port_rn(mesh, job):
    from uml_tpu_torch.models import clip as tclip
    from uml_tpu_torch.models import clip_resnet as trn
    from uml_tpu_torch.models import uml_head as thead
    from uml_tpu_torch.train import optim as toptim
    from uml_tpu_torch.train import supervised as tsup

    port = tclip.ClipResNetModel(trn.ClipResNetConfig(**TINY_RN),
                                 tclip.ClipConfig(**RN_TEXT), dtype=torch.float32)
    th = thead.make_uml_clip_head(port, 3, logit_scale=0.0, freeze_backbone=False)
    th.load_state_tree(job["init"])
    log = ListLogger()
    out = tsup.train(
        th, tsup.CyclicBatcher(job["imgs"], job["labels"], 8, seed=0), None,
        tsup.eval_batches(job["imgs"], job["labels"], 8),
        optimizer=toptim.build_optimizer(
            "sgd", toptim.build_schedule(RN_LR, "cosine", 0, RN_STEPS), 0.0),
        max_iters=RN_STEPS, eval_freq=1, patience=5, logger=log,
        validate_fn=RisingValidate(), mesh=mesh)
    return {"rows": log.rows, "model": {
        "backbone": {k: v.numpy() for k, v in th.backbone.state_dict().items()},
        "head_w": th.head_w.detach().numpy()}}


def _port_selfsup(mesh, job):
    from uml_tpu_torch.cli.multibench import _affect_streams
    from uml_tpu_torch.data.affect import load_affect
    from uml_tpu_torch.models.seq_autoencoder import make_seq_uml
    from uml_tpu_torch.train.selfsup import SelfSupTrainer, train_selfsup

    class Trainer(SelfSupTrainer):
        def init(self):
            model = super().init()
            if job["init"] is not None:
                model.load_state_dict(job["init"])
            return model

    splits = load_affect(job["path"])
    s1, s2, evals = _affect_streams(splits, None, job["bs"])
    model = make_seq_uml(6, 10, 10, info_nce=job["info_nce"], dropout=job["dropout"])
    trainer = Trainer(model, lr=SELFSUP_LR, seed=0, device="cpu")
    log = ListLogger()
    model, score, _ = train_selfsup(
        trainer, s1, s2, evals, mode="xy", num_epochs=job["epochs"], ds_name="mosi",
        eval_freq=1000, capture=False, logger=log, mesh=mesh)
    return {"rows": log.rows, "score": score,
            "model": {k: v.numpy() for k, v in model.state_dict().items()}}


def _port_autograd(mesh, job):
    from uml_tpu_torch.core.meshes import data_rank
    from uml_tpu_torch.parallel.data_parallel import BatchShard

    shard = BatchShard(mesh, True)
    x = torch.tensor(job["x"][data_rank(mesh)], requires_grad=True)
    w = torch.tensor(job["w"])
    loss = shard.sum(((shard.gather(x) * w) ** 2).sum() * (data_rank(mesh) + 1))
    loss.backward()
    return {"loss": loss.item(), "grad": x.grad.numpy()}


def _port_features(mesh, job):
    import uml_tpu_torch.native
    from uml_tpu_torch.cli import features

    uml_tpu_torch.native.native_available = lambda: False
    os.environ.update(job["env"])
    args = features.build_parser().parse_args(job["argv"])
    args.overwrite, args.force_rerun = False, False
    features.main(args)
    return {}


PORT = {"frozen": _port_frozen, "rn": _port_rn, "selfsup_mse": _port_selfsup,
        "selfsup_nce": _port_selfsup, "selfsup_dropout": _port_selfsup,
        "autograd": _port_autograd, "features": _port_features}


def _worker(rank, store, jobs_path, out_dir):
    os.environ.update(UML_COORDINATOR=f"file://{store}", UML_NUM_PROCESSES=str(WORLD),
                      UML_PROCESS_ID=str(rank), UML_TORCH_DEVICE="cpu")
    torch.set_num_threads(1)
    import torch.distributed as dist

    from uml_tpu_torch.core.meshes import mesh_from_flag

    mesh = mesh_from_flag("auto")
    jobs = torch.load(jobs_path, weights_only=False)
    out = {name: PORT[name](mesh, job) for name, job in jobs.items()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _run_ranks(tmp, jobs):
    """Run ``jobs`` on WORLD gloo ranks -> each rank's outputs."""
    import torch.multiprocessing as mp

    jobs_path = str(tmp / "jobs.pt")
    torch.save(jobs, jobs_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, str(tmp / "store"), jobs_path, str(tmp)))
             for r in range(WORLD)]
    # each rank iterates a set in an order of its own: what they must
    # agree on comes from rank 0
    saved = os.environ.get("PYTHONHASHSEED")
    try:
        for r, p in enumerate(procs):
            os.environ["PYTHONHASHSEED"] = str(r + 1)
            p.start()
    finally:
        if saved is None:
            os.environ.pop("PYTHONHASHSEED", None)
        else:
            os.environ["PYTHONHASHSEED"] = saved
    for p in procs:
        p.join(JOIN_TIMEOUT)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} rank(s) still running after {JOIN_TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


# -- uml_tpu's side and the jobs -----------------------------------------------


def _features(n_per_class, n_classes, dim, seed, centers):
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(n_classes), n_per_class)
    feats = centers[labels] + rng.standard_normal((len(labels), dim))
    return feats.astype(np.float32), labels.astype(np.int64)


def _frozen_case():
    from uml_tpu.core.meshes import create_mesh
    from uml_tpu.models import uml_head as jhead
    from uml_tpu.train import optim as joptim
    from uml_tpu.train import supervised as jsup
    from uml_tpu_torch.models.convert import uml_head_params_from_jax

    n_classes, img_dim, txt_dim = 6, 16, 8
    rng = np.random.default_rng(0)
    img_centers = rng.standard_normal((n_classes, img_dim)) * 0.5
    txt_centers = rng.standard_normal((n_classes, txt_dim)) * 0.5
    # 54 images at 16: the last batch holds 6 rows and 10 padding rows,
    # so the second rank's 8 rows are all padding
    img, img_lab = _features(9, n_classes, img_dim, 1, img_centers)
    txt, txt_lab = _features(6, n_classes, txt_dim, 2, txt_centers)
    val, val_lab = _features(4, n_classes, img_dim, 3, img_centers)
    capture = {"image_feats": img[:24], "image_labels": img_lab[:24],
               "text_feats": txt[:24]}
    sched = (0.01, "cosine", 5, 30, "linear", 1e-4)
    kw = dict(max_iters=30, alpha=0.7, img_alpha=1.0, eval_freq=4, patience=2,
              capture=capture)
    jm = jhead.UMLHead(feat_dim=img_dim, num_classes=n_classes, text_indim=txt_dim,
                       learnable_temp=True)
    params = jm.init_params(seed=0)
    job = dict(img=img, img_lab=img_lab, txt=txt, txt_lab=txt_lab, val=val,
               val_lab=val_lab, n_classes=n_classes, img_bs=16, txt_bs=15,
               sched=sched, kw=kw, init=uml_head_params_from_jax(_np(params)))
    log = ListLogger()
    out = jsup.train(
        jm, jsup.CyclicBatcher(img, img_lab, 16, seed=0),
        jsup.CyclicBatcher(txt, txt_lab, 15, seed=1),
        jsup.eval_batches(val, val_lab, 16),
        optimizer=joptim.build_optimizer("adamw", joptim.build_schedule(*sched), 1e-4),
        logger=log, init_params=params, mesh=create_mesh(n_data=WORLD), **kw)
    return job, {"rows": log.rows, "iter": out["iter"], "val_acc": out["val_acc"],
                 "stopped_at": out["stopped_at"], "model": _np(out["model"])}


def _rn_case():
    import jax
    import jax.numpy as jnp

    from tests.test_torch_clip_resnet import _redraw_bn
    from uml_tpu.core.meshes import create_mesh
    from uml_tpu.models import clip as jclip
    from uml_tpu.models import clip_resnet as jrn
    from uml_tpu.models import uml_head as jhead
    from uml_tpu.train import optim as joptim
    from uml_tpu.train import supervised as jsup
    from uml_tpu_torch.models.convert import uml_head_params_from_jax

    rn = jrn.ClipResNetConfig(**TINY_RN)
    jmodel = jclip.ClipResNetModel(rn, jclip.ClipConfig(**RN_TEXT), dtype=jnp.float32,
                                   attn_impl="reference")
    v = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 77), jnp.int32))
    v = {"params": _redraw_bn(_np(v["params"]), np.random.default_rng(0))}
    jh = jhead.make_uml_clip_head(jmodel, v, 3, logit_scale=0.0, freeze_backbone=False)
    params = jh.init_params(seed=0)
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (6, 32 * 32 * 3), dtype=np.uint8)
    labels = rng.integers(0, 3, 6)
    job = dict(imgs=imgs, labels=labels, init=uml_head_params_from_jax(_np(params)))
    log = ListLogger()
    out = jsup.train(
        jh, jsup.CyclicBatcher(imgs, labels, 8, seed=0), None,
        jsup.eval_batches(imgs, labels, 8),
        optimizer=joptim.build_optimizer(
            "sgd", joptim.build_schedule(RN_LR, "cosine", 0, RN_STEPS), 0.0),
        max_iters=RN_STEPS, eval_freq=1, patience=5, logger=log, init_params=params,
        validate_fn=RisingValidate(), mesh=create_mesh(n_data=WORLD))
    return job, {"rows": log.rows, "model": uml_head_params_from_jax(_np(out["model"]))}


class _NoDropout:
    """uml_tpu's SeqUML with its dropout layers deterministic."""

    def __init__(self, model):
        self.model = model

    def init(self, *args, **kw):
        return self.model.init(*args, **kw)

    def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
        return self.model.apply(variables, *args, deterministic=True, **kw)

    def __getattr__(self, name):
        return getattr(self.model, name)


def _selfsup_case(path, info_nce):
    from uml_tpu.cli.multibench import _affect_streams
    from uml_tpu.core.meshes import create_mesh
    from uml_tpu.data.affect import load_affect
    from uml_tpu.models.seq_autoencoder import make_seq_uml
    from uml_tpu.train.selfsup import SelfSupTrainer, train_selfsup
    from uml_tpu_torch.models.convert import seq_uml_state_dict_from_jax

    splits = load_affect(path)
    trainer = SelfSupTrainer(_NoDropout(make_seq_uml(6, 10, 10, info_nce=info_nce)),
                             lr=SELFSUP_LR, seed=0)
    # the init's shapes from streams of their own: an epoch draws a shuffle
    s1, s2, _ = _affect_streams(splits, None, 12)
    d1, _, _ = next(iter(s1()))
    d2, _, _ = next(iter(s2()))
    init, _ = trainer.init(d1["x"].shape, d2["y"].shape)
    s1, s2, evals = _affect_streams(splits, None, 12)
    job = dict(path=path, bs=12, info_nce=info_nce, dropout=0.0, epochs=1,
               init=seq_uml_state_dict_from_jax(_np(init)))
    log = ListLogger()
    variables, score, _ = train_selfsup(
        trainer, s1, s2, evals, mode="xy", num_epochs=1, ds_name="mosi",
        eval_freq=1000, capture=False, logger=log, mesh=create_mesh(n_data=WORLD))
    return job, {"rows": log.rows, "score": score,
                 "model": seq_uml_state_dict_from_jax(_np(variables))}


def _caltech_setup(tmp):
    """A few-shot caltech101 fixture and a tiny ViT-B/32 checkpoint -> the
    features CLI's argv (without --feature_dir and --mesh) and env."""
    from tests.test_data_fewshot import make_caltech_fixture
    from tests.test_torch_features_cli import TINY_B32
    from uml_tpu.cli import generate_fewshot as gf
    from uml_tpu_torch.models.clip import CLIP

    root = make_caltech_fixture(str(tmp / "data"))
    weights = tmp / "weights"
    weights.mkdir()
    model = CLIP(TINY_B32).init_random(torch.Generator().manual_seed(1))
    torch.save(model.state_dict(), str(weights / "ViT-B-32.pt"))
    gf.main(gf.build_parser().parse_args([
        "--data_dir", root, "--indices_dir", f"{root}/indices",
        "--dataset", "caltech101", "--train-shot", "2", "--seed", "1"]))
    descriptions = tmp / "descriptions"
    (descriptions / "cupl").mkdir(parents=True)
    (descriptions / "cupl" / "descriptors_caltech101.json").write_text(json.dumps(
        {**{f"class_{c}": [f"a photo of thing {c}.", f"thing {c}, seen closely."]
            for c in range(4)}, "no such class": ["unmatched."]}))
    argv = ["--data_dir", root, "--indices_dir", f"{root}/indices",
            "--dataset", "caltech101", "--clip-encoder", "ViT-B/32",
            "--train-shot", "2", "--seed", "1", "--text-augmentation",
            "hand_crafted", "--image-augmentation", "flip", "--batch-size", "3",
            "--num-workers", "1", "--descriptor_type", "gpt3_cupl",
            "--description_dir", str(descriptions)]
    env = {"UML_CLIP_WEIGHTS_DIR": str(weights), "UML_CLIP_VERIFY_SHA": "0",
           "UML_DECODE_WORKERS": "thread"}
    return argv, env


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """uml_tpu's references, the port's 1-rank runs and one 2-rank run of
    every job -> (references, the ranks' outputs, the 1-rank outputs)."""
    from tests.test_multibench import make_affect_pickle

    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("dp")
    path = str(tmp / "mosi_data.pkl")
    make_affect_pickle(path)
    refs, jobs = {}, {}
    jobs["frozen"], refs["frozen"] = _frozen_case()
    jobs["rn"], refs["rn"] = _rn_case()
    jobs["selfsup_mse"], refs["selfsup_mse"] = _selfsup_case(path, False)
    jobs["selfsup_nce"], refs["selfsup_nce"] = _selfsup_case(path, True)
    jobs["selfsup_dropout"] = dict(path=path, bs=12, info_nce=False, dropout=0.1,
                                   epochs=2, init=None)
    rng = np.random.default_rng(5)
    jobs["autograd"] = dict(x=rng.standard_normal((WORLD, 3, 4)).astype(np.float32),
                            w=rng.standard_normal((WORLD * 3, 4)).astype(np.float32))
    argv, env = _caltech_setup(tmp)
    jobs["features"] = dict(argv=argv + ["--feature_dir", str(tmp / "f2"),
                                         "--mesh", "auto"], env=env)

    single = {"selfsup_dropout": _port_selfsup(None, jobs["selfsup_dropout"])}
    import uml_tpu_torch.native
    from uml_tpu_torch.cli import features

    saved = {k: os.environ.get(k) for k in (*env, "UML_TORCH_DEVICE")}
    native = uml_tpu_torch.native.native_available
    os.environ.update(env, UML_TORCH_DEVICE="cpu")
    uml_tpu_torch.native.native_available = lambda: False
    try:
        args = features.build_parser().parse_args(
            argv + ["--feature_dir", str(tmp / "f1"), "--mesh", "off"])
        args.overwrite, args.force_rerun = False, False
        features.main(args)
    finally:
        uml_tpu_torch.native.native_available = native
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ranks = _run_ranks(tmp, jobs)
    return refs, ranks, single, tmp


# -- environment and rows ------------------------------------------------------


ENVS = [
    {},
    {"UML_COORDINATOR": "10.0.0.1:1234", "UML_NUM_PROCESSES": "4", "UML_PROCESS_ID": "2"},
    {"UML_COORDINATOR": "file:///shared/store"},
    {"SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_STEP_NODELIST": "node[3-17,21],x"},
    {"SLURM_NTASKS": "2", "SLURM_PROCID": "1", "SLURM_NODELIST": "gpu7",
     "UML_COORDINATOR_PORT": "9999"},
    {"SLURM_NTASKS": "1", "SLURM_PROCID": "0"},
    {"SLURM_NTASKS": "4", "SLURM_PROCID": "0"},
    {"UML_AUTO_DISTRIBUTED": "1"},
    {"UML_AUTO_DISTRIBUTED": "1", "SLURM_NTASKS": "2", "SLURM_PROCID": "1"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_detect_topology_matches_uml_tpu(env):
    from uml_tpu.core import distributed as jd
    from uml_tpu_torch.core import distributed as td

    want = jd.detect_topology(env)
    got = td.detect_topology(env)
    assert (got is None) == (want is None)
    if want is not None:
        assert (got.coordinator_address, got.num_processes, got.process_id) == (
            want.coordinator_address, want.num_processes, want.process_id)


class _Mesh:
    """A stand-in DeviceMesh: the data axis's size and this rank."""

    def __init__(self, size, rank):
        self._size, self._rank = size, rank

    def size(self, dim=0):
        return self._size

    def get_local_rank(self, name):
        return self._rank


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_maybe_shard_batch_keeps_this_ranks_rows(rank):
    from uml_tpu_torch.core.meshes import maybe_shard_batch

    mesh = _Mesh(4, rank)
    x = np.arange(16 * 3).reshape(16, 3)
    labels = torch.arange(16)
    ragged = np.arange(7)
    a, b, c, d = maybe_shard_batch(mesh, (x, labels, ragged, np.float32(2.0)))
    np.testing.assert_array_equal(a, x[4 * rank:4 * rank + 4])
    assert torch.equal(b, labels[4 * rank:4 * rank + 4])
    assert c is ragged and d == 2.0               # 7 rows: the batch stays whole
    tree = {"x": x}
    assert maybe_shard_batch(None, tree) is tree


def test_mesh_auto_starts_one_process_per_card(tmp_path):
    """Two 'cards' and no job in the environment: a CLI's command line
    (run_sweep_cli, ``-d --mesh auto``) starts two processes
    (UML_COORDINATOR on a free local port), which join as ranks 0 and 1
    of one group; the parent exits with the worst exit code."""
    script = tmp_path / "probe.py"
    script.write_text(
        "import argparse, sys\n"
        "from uml_tpu_torch.core import meshes\n"
        "from uml_tpu_torch.core.sweep import run_sweep_cli\n"
        "meshes.visible_cards = lambda: 2\n"
        "def main(args):\n"
        "    mesh = meshes.mesh_from_flag(args.mesh)\n"
        "    rank = meshes.data_rank(mesh)\n"
        "    print('RANK', rank, meshes.data_size(mesh), flush=True)\n"
        "    sys.exit(3 if rank == 1 else 0)\n"
        "parser = argparse.ArgumentParser()\n"
        "parser.add_argument('--mesh', default='off')\n"
        "run_sweep_cli(main, parser)\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("UML_", "SLURM_"))}
    env.update(UML_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, str(script), "-d", "--mesh", "auto"],
                          env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=JOIN_TIMEOUT)
    assert proc.returncode == 3, proc.stderr[-2000:]
    lines = sorted(ln for ln in proc.stdout.splitlines() if ln.startswith("RANK"))
    assert lines == ["RANK 0 2", "RANK 1 2"]


# -- the runs --------------------------------------------------------------------


def _rows_close(got, want, rtol, atol_keys=(), atol=0.0, loose=None):
    assert len(got) == len(want)
    for step, (t, j) in enumerate(zip(got, want)):
        assert set(t) == set(j), step
        for key in j:
            tol = loose.get(key, rtol) if loose else rtol
            a = atol if key.endswith(atol_keys) else 0.0
            np.testing.assert_allclose(t[key], float(j[key]), rtol=tol, atol=a,
                                       err_msg=f"{step} {key}")


def test_frozen_head_train_matches_the_mesh(dp_runs):
    refs, ranks, _, _ = dp_runs
    want = refs["frozen"]
    for got in (r["frozen"] for r in ranks):
        _rows_close(got["rows"], want["rows"], LOOP_RTOL, SIM_KEYS, SIM_ATOL)
        assert got["iter"] == want["iter"]
        assert got["stopped_at"] == want["stopped_at"]
        assert got["val_acc"] == pytest.approx(want["val_acc"], rel=LOOP_RTOL)
        for name, leaf in want["model"].items():
            np.testing.assert_allclose(got["model"][name], leaf, rtol=0,
                                       atol=LOOP_RTOL * np.abs(leaf).max(),
                                       err_msg=name)
    assert "train/grad_direction_sim" in want["rows"][0]


def test_rn_batch_norm_step_matches_the_mesh(dp_runs):
    refs, ranks, _, _ = dp_runs
    want = refs["rn"]
    for got in (r["rn"] for r in ranks):
        _rows_close(got["rows"], want["rows"], RN_RTOL)
        for key, w in want["model"]["backbone"].items():
            g = torch.as_tensor(got["model"]["backbone"][key])
            if key.endswith(("running_mean", "running_var")):
                torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
            elif key.endswith("attnpool.k_proj.bias"):
                # an exact zero gradient (the softmax cancels it): rounding
                assert max(g.abs().max().item(), w.abs().max().item()) < 1e-8
            else:
                assert (g - w).abs().max().item() <= (
                    RN_RTOL * max(w.abs().max().item(), 1e-6)), key
        np.testing.assert_allclose(got["model"]["head_w"], want["model"]["head_w"],
                                   rtol=0, atol=RN_RTOL)
    # the running statistics moved, the same way on both ranks
    for key, v in ranks[0]["rn"]["model"]["backbone"].items():
        np.testing.assert_array_equal(v, ranks[1]["rn"]["model"]["backbone"][key])


@pytest.mark.parametrize("case", ["selfsup_mse", "selfsup_nce"])
def test_selfsup_matches_the_mesh(dp_runs, case):
    refs, ranks, _, tmp = dp_runs
    want = refs[case]
    job = torch.load(str(tmp / "jobs.pt"), weights_only=False)[case]
    steps = len(want["rows"])
    for got in (r[case] for r in ranks):
        _rows_close(got["rows"], want["rows"], SELFSUP_METRIC_RTOL,
                    loose={"train/pred_effective_rank_y": RANK_RTOL,
                           "train/loss_private": RANK_RTOL})
        for key in ("test/score_x", "test/score_y", "test/score_xy"):
            assert got["score"][key] == pytest.approx(want["score"][key], abs=SCORE_ATOL)
        for key, ref in want["model"].items():
            p, ref = torch.as_tensor(got["model"][key]).clone(), ref.clone()
            init = job["init"][key]
            if key.endswith("qkv.bias"):
                k_bias = slice(10, 20)
                assert float((p[k_bias] - ref[k_bias]).abs().max()) <= (
                    5 * SELFSUP_LR * steps), key
                p[k_bias] = ref[k_bias]
                init = init.clone()
                init[k_bias] = ref[k_bias]
            # each element within one lr step, and the whole update (the
            # change from the init) within 1% of uml_tpu's in norm
            assert float((p - ref).abs().max()) <= SELFSUP_LR, key
            moved = (ref - init).norm()
            assert float((p - ref).norm()) <= SELFSUP_UPDATE_RTOL * float(moved), key
    for key, v in ranks[0][case]["model"].items():
        np.testing.assert_array_equal(v, ranks[1][case]["model"][key])


def test_selfsup_dropout_scores_match_one_rank(dp_runs):
    _, ranks, single, _ = dp_runs
    want = single["selfsup_dropout"]["score"]
    for key in ("test/score_x", "test/score_y", "test/score_xy"):
        assert ranks[0]["selfsup_dropout"]["score"][key] == pytest.approx(
            want[key], abs=SCORE_ATOL), key


def test_differentiable_collectives_match_autograd(dp_runs):
    _, ranks, _, tmp = dp_runs
    job = torch.load(str(tmp / "jobs.pt"), weights_only=False)["autograd"]
    x = torch.tensor(job["x"].reshape(-1, 4), requires_grad=True)
    w = torch.tensor(job["w"])
    # every rank's loss is the sum over ranks of (rank + 1) * |x w|^2
    loss = ((x * w) ** 2).sum() * sum(r + 1 for r in range(WORLD))
    loss.backward()
    for r, got in enumerate(ranks):
        assert got["autograd"]["loss"] == pytest.approx(loss.item(), rel=1e-6)
        # each rank's copy of the loss adds its gradient: WORLD times the
        # loss's, which sync_gradients' average brings back
        np.testing.assert_allclose(got["autograd"]["grad"],
                                   WORLD * x.grad.numpy()[3 * r:3 * r + 3], rtol=1e-6)


def _by_label(cache):
    """A text cache with its rows in label order: a class order comes from
    a set, whose order differs between processes (as in uml_tpu)."""
    order = np.argsort(cache["labels"], kind="stable")
    return {k: v[order] if k in ("features", "labels", "eot_indices") else v
            for k, v in cache.items()}


def test_two_rank_features_write_the_one_rank_caches(dp_runs):
    _, _, _, tmp = dp_runs
    from uml_tpu_torch.data.feature_cache import load_cache

    one = sorted(p.relative_to(tmp / "f1") for p in (tmp / "f1").rglob("*.pth"))
    two = sorted(p.relative_to(tmp / "f2") for p in (tmp / "f2").rglob("*.pth"))
    assert one == two and len(one) == 4     # train, test, text, descriptors
    for rel in one:
        a, b = load_cache(str(tmp / "f1" / rel)), load_cache(str(tmp / "f2" / rel))
        if "eot_indices" in a:
            a, b = _by_label(a), _by_label(b)
        _assert_equal(a, b, str(rel))


def _assert_equal(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (np.ndarray, torch.Tensor)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)
    else:
        assert a == b, where
