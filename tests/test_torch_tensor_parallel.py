"""The port's tensor parallelism against uml_tpu's, on the CPU.

uml_tpu shards a parameter tree over the ``model`` axis of a mesh of
virtual CPU devices (tests/conftest.py); the port shards a module's
tensors as DTensors over a (data, model) DeviceMesh of gloo processes.
Held here:

* the placements: ``infer_sharding_tree`` of the port's CLIP, DINO, seq
  autoencoder and LLaMA (float and ``int8_w``) puts every tensor where
  uml_tpu's ``infer_sharding_tree`` puts its counterpart on the same
  tree.  The names and layouts are mapped by ``models/convert.py``'s own
  converters: each uml_tpu leaf becomes a marker array that varies along
  its sharded axis (zeros when replicated), the converter carries it into
  the port's names (transposing what it transposes), and the axis along
  which the port's marker varies is the one its placement must shard;
* on 4 gloo ranks, a (2 data x 2 model) mesh (uml_tpu's tests use 4 x 2
  virtual devices), spawned once for the module:
  - a sharded c_fc -> relu -> c_proj product equals the replicated one
    within 1e-5 (uml_tpu's test_parallel.py case);
  - a tiny LLaMA (hidden 64, 4 heads over 2 kv heads), fp32 and
    ``int8_w``: pooled features under ``LLAMA_TP_RULES`` equal the
    unsharded ones within 1e-5, and each rank's local q_proj / down_proj
    (their ``kernel_q8`` under int8_w) holds 1/2 of the whole along the
    rule's axis (uml_tpu's test_llama.py cases);
  - a tiny 64 px CLIP on the fused half-block route (the kernels' plain
    versions here), tensor-parallel, each rank encoding its rows: within
    3e-4 of uml_tpu's plain-attention reference model on the same numpy
    weights (uml_tpu's test_mesh_pallas.py case);
  - the fused, non-fused, int8 and text routes of that CLIP, DINO (fp32
    and int8) and the seq autoencoder: outputs under the mesh equal those
    without it bit for bit, and every call of a half-block, its plain
    version or a non-fused op takes the shapes it takes without the mesh,
    with no DTensor among its tensors (no kernel runs on a shard);
  - under autograd, the gradient of each sharded parameter is its slice of
    the unsharded gradient (within 1e-6 of the largest); one step of the
    port's adamw (``train/optim.py``) with torch's multi-tensor kernels
    forced on, as they are on the card (they refuse a list mixing
    DTensors and tensors), updates a tensor-parallel model as the
    unsharded one, bit for bit;
  - ``TextModel(..., mesh=)`` and the features CLI's adapter with a mesh,
    on a tiny HF LLaMA saved in the test (tests/test_llama.py's
    ``_save_tiny_llama``), encode as without a mesh.
The ranks meet through a ``file://`` store under the test's directory and
are joined with a timeout.  JAX is imported where uml_tpu runs, not at
the top: the spawned ranks import this module and run the port alone.
"""

import os

import numpy as np
import pytest
import torch

WORLD = 4
N_MODEL = 2
JOIN_TIMEOUT = 300
MATMUL_ATOL = 1e-5
LLAMA_TOL = 1e-5
CLIP_ATOL = 3e-4
GRAD_REL = 1e-6
TINY_CLIP = dict(embed_dim=64, image_resolution=64, vision_layers=2, vision_width=128,
                 vision_patch_size=16, transformer_width=128, transformer_heads=2,
                 transformer_layers=2)
TINY_LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=112,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
DINO = dict(hidden_size=128, num_layers=2, num_heads=2, patch_size=14, image_size=56,
            pretrain_image_size=56)
SEQ = (6, 10, 10)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# -- placements ----------------------------------------------------------------


def _markers(params, specs):
    """Each leaf -> an array of its shape that varies along the axis its
    spec shards over 'model' (values 1..100, int8 for kernel_q8), zeros
    where it is replicated."""
    import jax

    def leaf(path, x, spec):
        name = str(getattr(path[-1], "key", path[-1]))
        dtype = np.int8 if name == "kernel_q8" else np.float32
        shape = np.shape(x)
        axes = [i for i, a in enumerate(tuple(spec)) if a == "model"]
        if not axes:
            return np.zeros(shape, dtype)
        d = axes[0]
        ramp = (np.arange(shape[d]) % 100 + 1).reshape(
            [-1 if i == d else 1 for i in range(len(shape))])
        return np.broadcast_to(ramp, shape).astype(dtype)

    return jax.tree_util.tree_map_with_path(leaf, params, specs)


def _axis(t):
    """The one axis along which a marker varies, or None (all zero)."""
    t = torch.as_tensor(t).float()
    if not bool(t.any()):
        return None
    varies = [d for d in range(t.ndim) if bool((t != t.narrow(d, 0, 1)).any())]
    assert len(varies) == 1, varies
    return varies[0]


def _case(name):
    """(uml_tpu param tree as numpy, its rules, converter, the port's
    module, the port's rules)."""
    import jax
    import jax.numpy as jnp

    from uml_tpu.models import clip as jclip
    from uml_tpu.models import dino as jdino
    from uml_tpu.models import llama as jllama
    from uml_tpu.models.seq_autoencoder import make_seq_uml as jseq
    from uml_tpu_torch.models import clip as tclip
    from uml_tpu_torch.models import convert
    from uml_tpu_torch.models import dino as tdino
    from uml_tpu_torch.models import llama as tllama
    from uml_tpu_torch.models.seq_autoencoder import make_seq_uml as tseq

    key = jax.random.key(0)
    if name == "clip":
        model = jclip.CLIP(jclip.ClipConfig(**TINY_CLIP), dtype=jnp.float32)
        tree = jax.eval_shape(model.init, key, jnp.zeros((1, 64, 64, 3)),
                              jnp.zeros((1, 77), jnp.int32))
        with torch.device("meta"):
            port = tclip.CLIP(tclip.ClipConfig(**TINY_CLIP))
        return tree, None, convert.state_dict_from_jax, port, None
    if name == "dino":
        model = jdino.DinoViT(jdino.DinoConfig(**DINO), dtype=jnp.float32)
        tree = jax.eval_shape(model.init, key, jnp.zeros((1, 56, 56, 3)))
        with torch.device("meta"):
            port = tdino.DinoViT(tdino.DinoConfig(**DINO))
        return tree, None, convert.dino_state_dict_from_jax, port, None
    if name == "seq":
        dx, dy, z = SEQ
        x, y = jnp.zeros((2, 4, dx)), jnp.zeros((2, 4, dy))
        lens = jnp.full((2,), 4, jnp.int32)
        tree = jax.eval_shape(jseq(dx, dy, z).init, key, x, y, lens, lens)
        with torch.device("meta"):
            port = tseq(dx, dy, z)
        return tree, None, convert.seq_uml_state_dict_from_jax, port, None
    quant = "int8_w" if name == "llama_int8" else "none"
    model = jllama.LlamaEncoder(jllama.LlamaConfig(**TINY_LLAMA))
    ids = jnp.ones((1, 4), jnp.int32)
    tree = jax.jit(model.init)(key, ids, ids)
    if quant == "int8_w":
        tree = jllama.quantize_llama_params(tree)
    with torch.device("meta"):
        port = tllama.LlamaEncoder(tllama.LlamaConfig(**TINY_LLAMA), quant=quant)
    return (tree, jllama.LLAMA_TP_RULES, convert.llama_state_dict_from_jax, port,
            tllama.LLAMA_TP_RULES)


@pytest.mark.parametrize("name", ["clip", "dino", "seq", "llama", "llama_int8"])
def test_placements_match_uml_tpu(name):
    from torch.distributed.tensor import Replicate, Shard

    from uml_tpu.parallel import infer_sharding_tree as jinfer
    from uml_tpu_torch.parallel import infer_sharding_tree

    tree, jrules, to_port, port, rules = _case(name)
    specs = jinfer(tree, jrules)
    markers = to_port(_markers(tree, specs))
    got = infer_sharding_tree(port, rules)
    assert sorted(got) == sorted(markers), set(got) ^ set(markers)
    sharded = 0
    for key, placement in got.items():
        axis = _axis(markers[key])
        want = Replicate() if axis is None else Shard(axis)
        assert placement == want, (key, placement, want)
        sharded += axis is not None
    assert sharded > 0


# -- gloo ranks ----------------------------------------------------------------


class _Spy:
    """Wraps module attributes, recording each call's tensor shapes and
    whether any tensor was a DTensor."""

    def __init__(self, targets):
        self.calls = []
        self.saved = []
        for module, name in targets:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))
            setattr(module, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        from torch.distributed.tensor import DTensor

        def spy(*args, **kwargs):
            flat = [a for a in list(args) + list(kwargs.values())
                    for a in (a if isinstance(a, (tuple, list)) else (a,))]
            tensors = [a for a in flat if isinstance(a, torch.Tensor)]
            self.calls.append((name, [tuple(t.shape) for t in tensors],
                               any(isinstance(t, DTensor) for t in tensors)))
            return fn(*args, **kwargs)
        return spy

    def restore(self):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def _spy_targets():
    from uml_tpu_torch.models import clip, dino
    from uml_tpu_torch.models import seq_autoencoder as seq
    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import ln_matmul as lm
    from uml_tpu_torch.ops import quant as q8

    names = {clip: ("attn_block", "attn_block_cls", "mlp_block", "attn_block_q8",
                    "mlp_block_q8", "ln_matmul", "add_ln_matmul", "multi_head_attention"),
             dino: ("attn_block", "attn_block_cls", "mlp_block", "attn_block_q8",
                    "mlp_block_q8"),
             fa: ("attn_block_plain", "attn_block_cls_plain"),
             lm: ("mlp_block_plain",),
             q8: ("attn_block_q8_plain", "mlp_block_q8_plain"),
             seq: ("mha_plain",)}
    return [(m, n) for m, ns in names.items() for n in ns if hasattr(m, n)]


def _routes(mesh):
    """Each route's outputs with and without the mesh -> {route: (equal,
    same call shapes, any DTensor reached a call, calls)}."""
    from uml_tpu_torch.models import clip, dino, seq_autoencoder
    from uml_tpu_torch.parallel import apply_tp_sharding

    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 64, 64, 3), dtype=np.uint8))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        1, 400, (2, 9)))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 5, SEQ[0])).astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5, SEQ[1])).astype(np.float32))
    lens = torch.full((2,), 5)

    def clip_model(**kw):
        return clip.CLIP(clip.ClipConfig(**TINY_CLIP), torch.float32, **kw).init_random(
            torch.Generator().manual_seed(0))

    def dino_model(**kw):
        m = dino.DinoViT(dino.DinoConfig(**DINO), **kw)
        return m.init_random(torch.Generator().manual_seed(0))

    def seq_model():
        m = seq_autoencoder.make_seq_uml(*SEQ, dropout=0.0)
        return m.init_random(torch.Generator().manual_seed(0))

    cases = {
        "clip_fused": (lambda: clip_model(attn_impl="fused", ln_matmul_impl="pallas"),
                       lambda m: m.encode_image_u8(u8)),
        "clip_unfused": (lambda: clip_model(attn_impl="reference"),
                         lambda m: m.encode_image_u8(u8)),
        "clip_int8": (lambda: clip_model(quant="int8"), lambda m: m.encode_image_u8(u8)),
        "clip_text": (clip_model, lambda m: m.encode_text(tokens)),
        "dino": (dino_model, lambda m: m.encode_image_u8(u8[:, :56, :56].reshape(2, -1))),
        "dino_int8": (lambda: dino_model(quant="int8"),
                      lambda m: m.encode_image_u8(u8[:, :56, :56].reshape(2, -1))),
        "seq": (seq_model, lambda m: m(x, y, lens, lens)["loss_x"]),
    }
    out = {}
    for route, (build, run) in cases.items():
        results, calls = [], []
        for tp in (False, True):
            model = build().eval()
            if tp:
                apply_tp_sharding(model, mesh)
            spy = _Spy(_spy_targets())
            try:
                with torch.no_grad():
                    results.append(run(model))
            finally:
                spy.restore()
            calls.append(spy.calls)
        out[route] = (torch.equal(results[0], results[1]),
                      [c[:2] for c in calls[0]] == [c[:2] for c in calls[1]],
                      any(c[2] for c in calls[1]), len(calls[1]))
    return out


def _port_matmul(mesh, job):
    from uml_tpu_torch.parallel import apply_tp_sharding

    def build():
        m = torch.nn.Module()
        m.block = torch.nn.Module()
        m.block.c_fc = torch.nn.Linear(8, 16)
        m.block.c_proj = torch.nn.Linear(16, 8)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in job["params"].items()})
        return m

    def mlp(m, x):
        return m.block.c_proj(torch.relu(m.block.c_fc(x)))

    x = torch.from_numpy(job["x"])
    sharded = apply_tp_sharding(build(), mesh)
    with torch.no_grad():
        return {"want": mlp(build(), x), "got": mlp(sharded, x),
                "local_fc": tuple(sharded.block.c_fc.parametrizations.weight
                                  .original.to_local().shape)}


def _port_llama(mesh, job):
    from uml_tpu_torch.models.llama import (LLAMA_TP_RULES, LlamaConfig, LlamaEncoder,
                                            quantize_llama_params)
    from uml_tpu_torch.parallel import apply_tp_sharding

    cfg = LlamaConfig(**TINY_LLAMA)
    ids, mask = torch.from_numpy(job["ids"]), torch.from_numpy(job["mask"])
    sd = LlamaEncoder(cfg).init_random(torch.Generator().manual_seed(0)).state_dict()
    out = {}
    for quant in ("none", "int8_w"):
        def build():
            model = LlamaEncoder(cfg, quant=quant)
            model.load_state_dict(quantize_llama_params(sd) if quant == "int8_w" else sd)
            return model.eval()

        def pooled(model):
            with torch.no_grad():
                hidden = model(ids, mask)
            m = mask[..., None].float()
            return (hidden * m).sum(1) / m.sum(1)

        base = pooled(build())
        model = apply_tp_sharding(build(), mesh, rules=LLAMA_TP_RULES)
        leaf = "kernel_q8" if quant == "int8_w" else "weight"
        layer = model.layers[0]
        shapes = {n: (tuple(getattr(mod.parametrizations, leaf).original.to_local().shape),
                      tuple(getattr(mod, leaf).shape))
                  for n, mod in (("q_proj", layer.self_attn["q_proj"]),
                                 ("down_proj", layer.mlp["down_proj"]))}
        out[quant] = {"base": base, "tp": pooled(model), "shapes": shapes}
    return out


def _port_clip(mesh, job):
    from uml_tpu_torch.core.meshes import maybe_shard_batch
    from uml_tpu_torch.models.clip import CLIP, ClipConfig
    from uml_tpu_torch.models.convert import state_dict_from_jax
    from uml_tpu_torch.parallel import apply_tp_sharding

    model = CLIP(ClipConfig(**TINY_CLIP), torch.float32, attn_impl="fused",
                 ln_matmul_impl="pallas")
    model.load_state_dict(state_dict_from_jax(job["variables"]))
    apply_tp_sharding(model, mesh)
    with torch.no_grad():
        got = model.encode_image_u8(torch.from_numpy(maybe_shard_batch(mesh, job["u8"])))
    return {"got": got, "want": torch.from_numpy(maybe_shard_batch(mesh, job["want"]))}


def _port_routes(mesh, job):
    return _routes(mesh)


def _port_grad(mesh, job):
    """The fused route under autograd: each sharded parameter's gradient
    against its slice of the unsharded model's."""
    from uml_tpu_torch.models.clip import CLIP, ClipConfig
    from uml_tpu_torch.parallel import apply_tp_sharding
    from uml_tpu_torch.parallel.tensor_parallel import declared_name, whole

    u8 = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, 64, 64, 3), dtype=np.uint8))
    grads = []
    for tp in (False, True):
        model = CLIP(ClipConfig(**TINY_CLIP), torch.float32).init_random(
            torch.Generator().manual_seed(0))
        if tp:
            apply_tp_sharding(model, mesh)
        model.encode_image_u8(u8).square().sum().backward()
        grads.append({declared_name(n): p for n, p in model.named_parameters()
                      if p.grad is not None})
    worst, n_sharded = 0.0, 0
    for name, p in grads[1].items():
        want = grads[0][name].grad
        got = whole(p.grad)
        if got is not p.grad:
            n_sharded += 1
            assert tuple(p.grad.to_local().shape) != tuple(want.shape)
        worst = max(worst, float((got - want).abs().max()) / float(want.abs().max()))
    return {"worst": worst, "n_sharded": n_sharded}


def _port_optimizer(mesh, job):
    """One adamw step of the port's Optimizer on a TP model and on the same
    model unsharded, the multi-tensor path forced on."""
    from uml_tpu_torch.parallel import apply_tp_sharding
    from uml_tpu_torch.parallel.tensor_parallel import declared_name, whole
    from uml_tpu_torch.train import optim

    torch.manual_seed(0)

    def build():
        m = torch.nn.Module()
        m.c_fc, m.c_proj = torch.nn.Linear(8, 16), torch.nn.Linear(16, 8)
        m.head = torch.nn.Parameter(torch.ones(8))
        return m

    plain, tp = build(), build()
    tp.load_state_dict(plain.state_dict())
    apply_tp_sharding(tp, mesh)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32))
    for m in (plain, tp):
        opt = optim.build_optimizer("adamw", optim.build_schedule(1e-2, "cosine", 0, 10),
                                    0.05).init(list(m.parameters()))
        for group in opt.torch_optimizer.param_groups:
            group["foreach"] = True
        opt.zero_grad()
        (m.c_proj(torch.relu(m.c_fc(x))) * m.head).square().sum().backward()
        opt.step(0)
    tp_params = {declared_name(n): p for n, p in tp.named_parameters()}
    return {"equal": all(torch.equal(p, whole(tp_params[n])) for n, p in plain.named_parameters()),
            "groups": len(opt.torch_optimizer.param_groups)}


def _port_textmodel(mesh, job):
    """TextModel without a mesh, and the features CLI's adapter handing
    its mesh to TextModel."""
    from uml_tpu_torch.cli.features import _HFEncoderAdapter
    from uml_tpu_torch.models.languagemodel import TextModel

    texts = ["a photo of cat", "the dog", "a photo of the dog"]
    base = TextModel(job["dir"], device="cpu").encode(texts)[0]
    adapter = _HFEncoderAdapter(language_model=job["dir"], device="cpu", mesh=mesh)
    tp = adapter.text_model
    return {"base": base, "tp": tp.encode(texts)[0],
            "sharded": sum(1 for n, _ in tp.model.named_parameters() if "original" in n),
            "mesh": tp.mesh is mesh}


PORT = {"matmul": _port_matmul, "llama": _port_llama, "clip": _port_clip,
        "routes": _port_routes, "grad": _port_grad, "optimizer": _port_optimizer,
        "textmodel": _port_textmodel}


def _worker(rank, store, jobs_path, out_dir):
    # USE_TF=0: transformers would import TensorFlow (seconds) for nothing
    os.environ.update(UML_COORDINATOR=f"file://{store}", UML_NUM_PROCESSES=str(WORLD),
                      UML_PROCESS_ID=str(rank), UML_TORCH_DEVICE="cpu", USE_TF="0")
    torch.set_num_threads(1)
    import torch.distributed as dist

    from uml_tpu_torch.core.distributed import maybe_initialize
    from uml_tpu_torch.core.meshes import create_mesh

    assert maybe_initialize()
    mesh = create_mesh(WORLD // N_MODEL, N_MODEL)
    jobs = torch.load(jobs_path, weights_only=False)
    out = {name: PORT[name](mesh, job) for name, job in jobs.items()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _run_ranks(tmp, jobs):
    import torch.multiprocessing as mp

    jobs_path = str(tmp / "jobs.pt")
    torch.save(jobs, jobs_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, str(tmp / "store"), jobs_path, str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
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


def _jobs(tmp):
    import jax
    import jax.numpy as jnp

    from tests.test_llama import _save_tiny_llama
    from uml_tpu.models.clip import CLIP, ClipConfig

    rng = np.random.default_rng(1)
    matmul = {"params": {
        "block.c_fc.weight": rng.standard_normal((16, 8)).astype(np.float32),
        "block.c_fc.bias": rng.standard_normal(16).astype(np.float32),
        "block.c_proj.weight": rng.standard_normal((8, 16)).astype(np.float32),
        "block.c_proj.bias": rng.standard_normal(8).astype(np.float32)},
        "x": rng.standard_normal((8, 8)).astype(np.float32)}
    ids = np.random.default_rng(2).integers(1, 128, (3, 11))
    mask = np.ones((3, 11), np.int64)
    mask[1, 7:], ids[1, 7:] = 0, 0

    refm = CLIP(ClipConfig(**TINY_CLIP), dtype=jnp.float32, attn_impl="reference",
                ln_matmul_impl="reference")
    variables = jax.jit(refm.init)(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                                   jnp.zeros((1, 77), jnp.int32))
    u8 = np.random.default_rng(1).integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
    want = np.asarray(refm.apply(variables, jnp.asarray(u8.reshape(8, -1)),
                                 method=lambda m, x: m.encode_image_u8(x)), np.float32)
    llama_dir = str(tmp / "tiny-llama")
    saved = os.environ.get("USE_TF")
    os.environ["USE_TF"] = "0"
    try:
        _save_tiny_llama(llama_dir)
    finally:
        if saved is None:
            os.environ.pop("USE_TF")
        else:
            os.environ["USE_TF"] = saved
    return {"matmul": matmul, "llama": {"ids": ids, "mask": mask},
            "clip": {"variables": jax.tree.map(np.asarray, variables), "u8": u8,
                     "want": want},
            "routes": {}, "grad": {}, "optimizer": {}, "textmodel": {"dir": llama_dir}}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    return _run_ranks(tmp, _jobs(tmp))


def test_sharded_matmul_matches_replicated(tp_runs):
    for out in tp_runs:
        r = out["matmul"]
        torch.testing.assert_close(r["got"], r["want"], atol=MATMUL_ATOL, rtol=0)
        assert r["local_fc"] == (16 // N_MODEL, 8)


@pytest.mark.parametrize("quant", ["none", "int8_w"])
def test_llama_tp_matches_unsharded(tp_runs, quant):
    for out in tp_runs:
        r = out["llama"][quant]
        torch.testing.assert_close(r["tp"], r["base"], atol=LLAMA_TOL, rtol=LLAMA_TOL)
        (q_local, q_whole), (d_local, d_whole) = r["shapes"]["q_proj"], r["shapes"]["down_proj"]
        # float [out, in]: q_proj col -> dim 0, down_proj row -> dim 1;
        # int8_w's kernel_q8 [in, out]: the other way round
        q_dim, d_dim = (0, 1) if quant == "none" else (1, 0)
        assert q_local[q_dim] * N_MODEL == q_whole[q_dim]
        assert q_local[1 - q_dim] == q_whole[1 - q_dim]
        assert d_local[d_dim] * N_MODEL == d_whole[d_dim]
        assert d_local[1 - d_dim] == d_whole[1 - d_dim]


def test_tiny_clip_tp_dp_matches_uml_tpu_reference(tp_runs):
    rows = []
    for out in tp_runs:
        r = out["clip"]
        torch.testing.assert_close(r["got"], r["want"], atol=CLIP_ATOL, rtol=CLIP_ATOL)
        rows.append(r["got"].shape[0])
    assert rows == [8 // (WORLD // N_MODEL)] * WORLD


@pytest.mark.parametrize("route", ["clip_fused", "clip_unfused", "clip_int8", "clip_text",
                                   "dino", "dino_int8", "seq"])
def test_routes_run_on_whole_weights(tp_runs, route):
    for out in tp_runs:
        equal, same_shapes, saw_dtensor, n_calls = out["routes"][route]
        assert equal and same_shapes and not saw_dtensor, (route, equal, same_shapes,
                                                           saw_dtensor)
        assert n_calls > 0


def test_gradients_reach_the_sharded_parameters(tp_runs):
    for out in tp_runs:
        r = out["grad"]
        assert r["n_sharded"] > 0
        assert r["worst"] <= GRAD_REL, r["worst"]


def test_optimizer_steps_tensor_parallel_parameters(tp_runs):
    for out in tp_runs:
        assert out["optimizer"] == {"equal": True, "groups": 2}


def test_text_model_over_the_mesh(tp_runs):
    for out in tp_runs:
        r = out["textmodel"]
        assert r["sharded"] > 0 and r["mesh"]
        np.testing.assert_allclose(r["tp"], r["base"], atol=LLAMA_TOL, rtol=LLAMA_TOL)
