"""Feature extraction on pre-decoded images, closed loop, one client.

Set-up builds the program's CLIP from the seed's weights and the
features CLI's encoder around it (``models/encoders.py::ClipEncoder``),
and a host pool of distinct uint8 batches.  The window drives, for each
batch, ``stage_images`` (the copy to the device on its own stream, out
of the pinned ring), ``encode_staged`` (the forward's dispatch) and
``PendingOutput``, reading each output ``FETCH_WINDOW`` dispatches late
as ``cli/features.py::image_features`` reads them (the CLI's own
constant, so the cell follows the CLI's policy).  Decode is left out:
on the card's host it caps the pipeline near 1,500 img/s, and a
decode-paced number would not repeat.  There is no feeder thread: with
nothing to decode, staging takes one thread.

After the window a sample of the fetched batches, drawn from the seed
and always holding the last, is compared with the plain reference's
float32 features of the same images.
"""

from __future__ import annotations

import statistics
import time
from collections import deque

import numpy as np
import torch

from port_bench import compare, flops, harness
from port_bench.images import make as make_images
from port_bench.reference import precision
from port_bench.reference.uml import features

SPAN = "port_bench.batch"


def encoder(model, device, quant: str = "none"):
    """The features CLI's ClipEncoder around a model already built, as
    the CLI's DINO adapter sets one up (``cli/features.py``)."""
    from uml_tpu_torch.models.encoders import ClipEncoder

    class _Encoder(ClipEncoder):
        def __init__(self):
            self.name = "port_bench"
            self.device = torch.device(device)
            self.model = model.eval()
            self.check_finite = False
            self._ring = None

    model.quant = quant
    return _Encoder()


def pool(wl, cfg, fam, seed, device) -> np.ndarray:
    """[pool_batches, batch, r, r, 3] uint8 images made from the seed."""
    r = fam.resolution(cfg)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return make_images(gen, wl["pool_batches"] * wl["batch"], r,
                       device).reshape(wl["pool_batches"], wl["batch"], r, r, 3).cpu().numpy()


class Pipeline:
    """The features CLI's loop without decode: ``one()`` stages the next
    pool batch, dispatches its forward and fetches the output dispatched
    ``FETCH_WINDOW`` batches earlier; ``drain()`` fetches the rest."""

    def __init__(self, enc, images):
        from uml_tpu_torch.cli.features import FETCH_WINDOW

        self.enc, self.images, self.fetch_window = enc, images, FETCH_WINDOW
        self.pending, self.results = deque(), {}
        self.stage, self.dispatch = [], []
        self.j = 0

    def one(self) -> None:
        from uml_tpu_torch.models.encoders import PendingOutput

        t0 = time.perf_counter()
        staged, n = self.enc.stage_images(self.images[self.j % len(self.images)])
        t1 = time.perf_counter()
        out, n = self.enc.encode_staged(staged, n)
        t2 = time.perf_counter()
        self.pending.append((self.j, PendingOutput(out, n)))
        while len(self.pending) > self.fetch_window:
            k, po = self.pending.popleft()
            self.results[k] = po.result()
        self.stage.append(t1 - t0)
        self.dispatch.append(t2 - t1)
        self.j += 1

    def drain(self) -> None:
        while self.pending:
            k, po = self.pending.popleft()
            self.results[k] = po.result()


def pass_batches(enc, images, count: int) -> dict:
    """``count`` batches through the pipeline -> {batch index: features}."""
    pipe = Pipeline(enc, images)
    for _ in range(count):
        pipe.one()
    pipe.drain()
    return pipe.results


def reference_gaps(wl, cfg, fam, seed, device, images, results, picked, mm="fp32"):
    """The compared numbers of the picked batches' features."""
    sd = fam.image_tower_keys(fam.state_dict(cfg, seed, device))
    need = sorted({j % len(images) for j in picked})
    with precision.strict_fp32():
        ref = {i: features(fam.reference_features, cfg, sd, torch.from_numpy(images[i]).to(device),
                           precision.MATMULS[mm]).cpu() for i in need}
    prog = torch.cat([torch.from_numpy(np.asarray(results[j])) for j in picked])
    want = torch.cat([ref[j % len(images)] for j in picked])
    return compare.feature_numbers(prog.float(), want)


def run(wl, cfg, fam, seed, seconds, trace, device, t0) -> dict:
    marks = {"imports": time.perf_counter() - t0}
    t = time.perf_counter()
    images = pool(wl, cfg, fam, seed, device)
    marks["pool"] = time.perf_counter() - t
    t = time.perf_counter()
    sd = fam.state_dict(cfg, seed, device)
    enc = encoder(fam.build_backbone(cfg, sd, device), device)
    del sd
    marks["model"] = time.perf_counter() - t
    t = time.perf_counter()
    counts0 = fam.counters()
    pass_batches(enc, images, wl["warmup_batches"])
    route = harness.counter_delta(counts0, fam.counters(), wl["warmup_batches"])
    if trace:
        harness.warm_profiler(device)
    harness.reset_peak(device)
    marks["warm-up"] = time.perf_counter() - t
    start = time.perf_counter()
    setup_s = start - t0
    pipe = Pipeline(enc, images)
    while True:
        pipe.one()
        if time.perf_counter() >= start + seconds:
            break
    pipe.drain()
    span = time.perf_counter() - start
    peak = harness.peak_bytes(device)
    summary = None
    if trace:
        traced = Pipeline(enc, images)
        summary = harness.trace_spans(traced.one, wl["trace_steps"], SPAN, device)
        traced.drain()

    del enc
    harness.free(device)
    picked = compare.sample(seed, pipe.j, wl["check_batches"])
    numbers = reference_gaps(wl, cfg, fam, seed, device, images, pipe.results, picked)

    n = pipe.j
    ops = flops.extract(fam.forward_ops(cfg, wl["batch"]), fam.feature_width(cfg),
                        wl["batch"])
    peak_flops = flops.peak_flops(cfg["compute_dtype"])
    return {
        "e2e": {"extract_img_per_s": (len(pipe.results) * wl["batch"] / span, "img/s"),
                "setup_s": (setup_s, "s")},
        "attempted": n, "failed": n - len(pipe.results),
        "numbers": numbers,
        "memory_peak_bytes": peak,
        "layer": {"kind": "extract", "trace": summary, "steps": n, "window_s": span,
                  "model_flops": flops.model_flops(ops),
                  "peak_flops": peak_flops,
                  "least_s": flops.least_seconds(ops, peak_flops), "route": route,
                  "stage_ms": statistics.median(pipe.stage) * 1e3,
                  "dispatch_ms": statistics.median(pipe.dispatch) * 1e3},
        "notes": ["[setup] " + ", ".join(f"{k} {v:.3f} s" for k, v in marks.items()),
                  f"[route] launches per batch: {route}",
                  f"[batches] {n} in {span:.4f} s; compared batches {picked}",
                  f"[compare] mean feature gap {numbers['feature_gap_mean']}, widest "
                  f"{numbers['feature_gap']}"],
    }


def readings(wl, cfg, fam, seed, device, control: bool) -> list:
    """The program's features of a pass over the pool against the
    reference; with ``control``, the program's own int8 serving path
    (``quant="int8"``, the features CLI's ``--quant int8``) and the float8
    reference."""
    images = pool(wl, cfg, fam, seed, device)
    sd = fam.state_dict(cfg, seed, device)
    model = fam.build_backbone(cfg, sd, device)
    del sd
    picked = list(range(len(images)))
    out = []
    for name, quant in (("program", "none"),) + ((("control_int8", "int8"),) if control else ()):
        enc = encoder(model, device, quant)
        res = pass_batches(enc, images, len(images))
        out.append((name, reference_gaps(wl, cfg, fam, seed, device, images, res, picked)))
    if control:
        sd = fam.image_tower_keys(fam.state_dict(cfg, seed, device))
        with precision.strict_fp32():
            fp8 = {i: features(fam.reference_features, cfg, sd,
                               torch.from_numpy(images[i]).to(device),
                               precision.MATMULS["fp8"]).cpu().numpy() for i in picked}
        out.append(("control_fp8", reference_gaps(
            wl, cfg, fam, seed, device, images, fp8, picked)))
    del model
    harness.free(device)
    return out
