"""The full-model finetune step, closed loop, one client, as the CLI runs.

Set-up builds the program's model from the seed's weights
(families/<family>.py), the UML head as cli/finetune.py builds it on the
full path, the zero-shot head from the text rows, and
``train/supervised.py::make_train_step``'s step with the adamw of the
cell's optimizer settings.  It drives that step through its first
``warmup_steps`` steps on the first batches of the pool (every row
distinct) and keeps what the comparison reads of the first three: each
step's loss, each unit's first gradient norm from AdamW's state, each
unit's change after three steps (port_bench/compare.py).

The window then drives the same step object, cycling the host pool: a
step runs from the call into ``step`` with host batches (the program
copies them to the device in ``place``) to the read of every logged
metric, as ``train``'s logger reads them each step.

After the window the program's state is freed and the plain reference
(reference/uml.py) follows the same three steps in float32.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import compare, flops, harness
from port_bench.images import make as make_images
from port_bench.reference import precision
from port_bench.reference.uml import features, train_steps, unit_norms, zero_shot_head

SPAN = "port_bench.step"


def text_rows(wl, cfg, fam, sd, device, gen, images, labels):
    """Text rows for ``labels`` (the cell's ``text``).  ``normal``: unit
    normal rows.  ``image_aligned``: each class's mean is the mean of the
    reference's float32 features of its pool images (image i belongs to
    class i mod classes), less the mean of all of them, and a row is its
    class's mean plus normal noise at ``noise`` of the mean's RMS: as a
    CLIP text tower's class prompts align with its image features, and
    their common part adds alike to every logit.  The zero-shot head then
    gives each image a clear leading class, so the first gradient of the
    saturated softmax (logit scale 100) does not switch with the rounding
    of a near-tie."""
    spec = wl["text"]
    width = fam.text_width(cfg)
    noise = torch.randn((len(labels), width), generator=gen, device=device)
    if spec["rows"] == "normal":
        return noise
    with precision.strict_fp32():
        feats = features(fam.reference_features, cfg, fam.image_tower_keys(sd), images,
                         precision.matmul)
    c = wl["classes"]
    home = torch.arange(len(feats), device=device) % c
    means = torch.zeros((c, width), device=device).index_add_(0, home, feats)
    means /= torch.bincount(home, minlength=c).clamp(min=1)[:, None]
    means -= feats.mean(0)
    rms = means.pow(2).mean(1, keepdim=True).sqrt()
    lab = torch.as_tensor(labels, device=device)
    return means[lab] + spec["noise"] * rms[lab] * noise


def pools(wl, cfg, fam, seed, device, sd, marks=None):
    """(image batches, text batches, all text rows, their labels): host
    numpy batches (inputs, labels, weights) made from the seed on the
    device; ``sd``, the seed's weights, for image-aligned text rows.
    Text labels cycle the classes, so every class has rows.  ``marks``
    gets the seconds of the text rows (the reference's forward, for
    image-aligned rows)."""
    n, bs, tb, c = wl["pool_batches"], wl["batch"], wl["text_batch"], wl["classes"]
    r = fam.resolution(cfg)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    dev_imgs = make_images(gen, n * bs, r, device)
    imgs = dev_imgs.reshape(n, bs, r * r * 3).cpu().numpy()
    img_labels = torch.randint(0, c, (n, bs), generator=gen, device=device).cpu().numpy()
    order = torch.rand(n * tb, generator=gen, device=device).argsort().cpu().numpy()
    txt_labels = (order % c).reshape(n, tb).astype(np.int64)
    t = time.perf_counter()
    txt = text_rows(wl, cfg, fam, sd, device, gen, dev_imgs,
                    txt_labels.reshape(-1)).reshape(n, tb, -1).cpu().numpy()
    if marks is not None:
        marks["text rows"] = time.perf_counter() - t
    del dev_imgs
    img_b = [(imgs[i], img_labels[i], np.ones(bs, np.float32)) for i in range(n)]
    txt_b = [(txt[i], txt_labels[i], np.ones(tb, np.float32)) for i in range(n)]
    return img_b, txt_b, txt.reshape(n * tb, -1), txt_labels.reshape(-1)


def build(wl, cfg, fam, seed, device, sd, text_rows, text_labels, marks=None):
    """-> (head, optimizer spec, step): the program's objects, its model
    filled from ``sd``; ``marks`` gets the seconds to each stage."""
    marks = {} if marks is None else marks
    t = time.perf_counter()
    from uml_tpu_torch.train.optim import build_optimizer, build_schedule
    from uml_tpu_torch.train.supervised import make_train_step

    backbone = fam.build_backbone(cfg, sd, device)
    harness.sync(device)
    marks["backbone"] = time.perf_counter() - t
    head = fam.build_head(cfg, backbone, wl["classes"], seed,
                          fam.head_extra(cfg, seed, device)).to(device)
    head.zero_shot_init(text_rows, text_labels)
    marks["head"] = time.perf_counter() - t
    o = wl["optimizer"]
    optimizer = build_optimizer(o["optim"], build_schedule(
        o["lr"], o["lr_scheduler"], o["warmup_iter"], o["max_iter"],
        o["warmup_type"], o["warmup_min_lr"]), o["weight_decay"])
    step = make_train_step(head, optimizer, has_image=True, has_text=True,
                           alpha=wl["alpha"], img_alpha=wl["img_alpha"])
    return head, optimizer, step


def first_steps(head, optimizer, step, img_b, txt_b, n_steps: int, units) -> dict:
    """Drive ``n_steps`` steps (the first three compared) -> the program's
    readings by unit (``units``: reference.uml.unit_norms')."""
    leaves = [(k, p) for k, p in head.named_parameters() if p.requires_grad]
    start = [p.detach().clone() for _, p in leaves]
    out = {"losses": []}
    opt = optimizer.torch_optimizer
    beta1 = opt.param_groups[0]["betas"][0]
    for i in range(n_steps):
        loss, metrics = step(i, img_b[i % len(img_b)], txt_b[i % len(txt_b)])
        {k: float(v) for k, v in metrics.items()}
        if i < 3:
            out["losses"].append(float(loss))
        if i == 0:
            # a leaf the optimizer left without state reads a zero gradient
            out["grad_norms"] = {u: g / (1 - beta1) for u, g in unit_norms(
                {k: opt.state[p].get("exp_avg", torch.zeros_like(p)) for k, p in leaves},
                units).items()}
        if i == 2:
            out["change_norms"] = unit_norms(
                {k: p.detach() - s for (k, p), s in zip(leaves, start)}, units)
            del start
    return out


class Loop:
    """The window's step, as the CLI's loop drives it: one call into
    ``step`` on the next host batches, then the logger's read of every
    metric."""

    def __init__(self, step, img_b, txt_b, first: int):
        self.step, self.img_b, self.txt_b, self.i = step, img_b, txt_b, first

    def one(self) -> None:
        i = self.i
        _, metrics = self.step(i, self.img_b[i % len(self.img_b)],
                               self.txt_b[i % len(self.txt_b)])
        {k: float(v) for k, v in metrics.items()}
        self.i += 1


def window(loop: Loop, seconds: float) -> dict:
    """Closed loop for ``seconds``: -> step times, their ends and the
    window's span."""
    times, ends = [], []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        t0 = time.perf_counter()
        loop.one()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        ends.append(t1)
        if t1 >= deadline:
            break
    return {"times": times, "ends": ends, "start": t_start, "end": t1}


def tenths(win: dict, batch: int) -> list:
    """Samples a second of the steps that end in each tenth of the window
    (the last tenth takes the step that overruns it)."""
    span = (win["end"] - win["start"]) / 10
    counts = [0] * 10
    for end in win["ends"]:
        counts[min(int((end - win["start"]) / span), 9)] += 1
    return [round(c * batch / span, 1) for c in counts]


def reference(wl, cfg, fam, seed, device, img_b, txt_b, text_rows, text_labels,
              units, mm="fp32", rows=None):
    """The plain reference's readings of the first three steps."""
    sd = fam.image_tower_keys(fam.state_dict(cfg, seed, device))
    head = {"head_w": zero_shot_head(text_rows, text_labels, wl["classes"]).to(device),
            "scale": fam.head_scale(cfg), **fam.head_extra(cfg, seed, device)}
    batches = [(torch.from_numpy(img_b[i][0]).to(device),
                torch.from_numpy(np.asarray(img_b[i][1], np.int64)).to(device),
                torch.from_numpy(txt_b[i][0]).to(device),
                torch.from_numpy(txt_b[i][1]).to(device)) for i in range(3)]
    with precision.strict_fp32():
        return train_steps(fam.reference_features, cfg, sd, head, batches, wl["optimizer"],
                           wl["alpha"], wl["img_alpha"], precision.MATMULS[mm], units,
                           rows=rows)


def run(wl, cfg, fam, seed, seconds, trace, device, t0) -> dict:
    marks = {"imports": time.perf_counter() - t0}
    t = time.perf_counter()
    sd = fam.state_dict(cfg, seed, device)
    harness.sync(device)
    marks["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    img_b, txt_b, text_rows, text_labels = pools(wl, cfg, fam, seed, device, sd, marks)
    marks["pools"] = time.perf_counter() - t
    t = time.perf_counter()
    built = {}
    head, optimizer, step = build(wl, cfg, fam, seed, device, sd, text_rows, text_labels,
                                  built)
    del sd
    marks["model"] = time.perf_counter() - t
    marks.update({f"model: {k}": v for k, v in built.items()})
    t = time.perf_counter()
    leaf_names = [k for k, p in head.named_parameters() if p.requires_grad]
    n_params = sum(p.numel() for p in head.parameters() if p.requires_grad)
    # the tower's matrices, cast from float32 to bfloat16 every step
    n_tower = sum(p.numel() for k, p in head.named_parameters()
                  if p.requires_grad and p.dim() >= 2 and k.startswith(fam.TOWER_PREFIX))
    counts0 = fam.counters()
    prog_units, ref_units = fam.units(leaf_names)
    prog = first_steps(head, optimizer, step, img_b, txt_b, wl["warmup_steps"], prog_units)
    route = harness.counter_delta(counts0, fam.counters(), wl["warmup_steps"])
    if trace:
        harness.warm_profiler(device)
    loop = Loop(step, img_b, txt_b, wl["warmup_steps"])
    harness.reset_peak(device)
    # the reference's forward that made the text rows is not set-up
    setup_s = time.perf_counter() - t0 - marks.get("text rows", 0.0)
    marks["first steps"] = time.perf_counter() - t
    win = window(loop, seconds)
    peak = harness.peak_bytes(device)
    summary = (harness.trace_spans(loop.one, wl["trace_steps"], SPAN, device)
               if trace else None)

    del head, optimizer, step, loop
    harness.free(device)
    ref = reference(wl, cfg, fam, seed, device, img_b, txt_b, text_rows, text_labels,
                    ref_units)
    numbers = compare.train_numbers(prog, ref)

    steps = len(win["times"])
    span = win["end"] - win["start"]
    ops = flops.train_step(fam.forward_ops(cfg, wl["batch"]), fam.feature_width(cfg),
                           wl["batch"], wl["text_batch"], wl["classes"],
                           fam.text_width(cfg), n_params, n_tower)
    peak_flops = flops.peak_flops(cfg["compute_dtype"])
    return {
        "e2e": {"train_samples_per_s": (steps * wl["batch"] / span, "samples/s"),
                "train_step_p95_ms": (harness.percentile(win["times"], 95) * 1e3, "ms"),
                "setup_s": (setup_s, "s")},
        "attempted": steps, "failed": 0,
        "numbers": numbers,
        "memory_peak_bytes": peak,
        "layer": {"kind": "train", "trace": summary, "steps": steps, "window_s": span,
                  "model_flops": flops.model_flops(ops),
                  "peak_flops": peak_flops,
                  "least_s": flops.least_seconds(ops, peak_flops), "route": route},
        "notes": ["[setup] " + ", ".join(f"{k} {v:.3f} s" for k, v in marks.items()),
                  f"[route] launches per step: {route}",
                  f"[steps] {steps} in {span:.4f} s; median "
                  f"{harness.percentile(win['times'], 50) * 1e3:.4f} ms",
                  f"[steps] samples/s by tenth of the window: "
                  f"{tenths(win, wl['batch'])}",
                  f"[compare] units compared {numbers['units_compared']}, left out "
                  f"{numbers['units_left_out']}; worst grad unit "
                  f"{numbers['worst_grad_unit']}, worst change unit "
                  f"{numbers['worst_change_unit']}",
                  f"[compare] losses program {prog['losses']} reference {ref['losses']}"],
    }


def readings(wl, cfg, fam, seed, device, control: bool) -> list:
    """The lower readings, the program's first three steps against the plain
    reference; with ``control``, the reference in float8 e4m3 products put
    in the program's place (the control) and the reference with the mean
    taken over half of each image batch (the fault "half of the batch left
    out").  A state left unchanged reads 1 on ``change_gap`` by its measure
    and needs no run."""
    sd = fam.state_dict(cfg, seed, device)
    img_b, txt_b, rows, labels = pools(wl, cfg, fam, seed, device, sd)
    head, optimizer, step = build(wl, cfg, fam, seed, device, sd, rows, labels)
    del sd
    leaf_names = [k for k, p in head.named_parameters() if p.requires_grad]
    prog_units, ref_units = fam.units(leaf_names)
    prog = first_steps(head, optimizer, step, img_b, txt_b, 3, prog_units)
    del head, optimizer, step
    harness.free(device)
    args = (wl, cfg, fam, seed, device, img_b, txt_b, rows, labels, ref_units)
    ref = reference(*args)
    def numbers(got):
        return {**compare.train_numbers(got, ref), "losses": got["losses"],
                "ref_losses": ref["losses"]}

    out = [("program", numbers(prog))]
    if control:
        out.append(("control_fp8", numbers(reference(*args, mm="fp8"))))
        out.append(("fault_half_batch", numbers(
            reference(*args, rows=wl["batch"] // 2))))
    return out
