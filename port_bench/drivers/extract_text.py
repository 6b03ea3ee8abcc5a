"""Text-feature extraction through the features CLI's language-model
path, closed loop, one client.

Set-up draws the text encoder's weights from the seed on the device and
builds the program's ``TextModel`` over them (``TextModel.native``: no
tokenizer, no ``transformers``, no files), and a pool of calls.  A call
is one class's descriptors, as ``cli/features.py::descriptor_features``
encodes one class a call: ``rows`` rows, each one BOS id and as many ids
as its descriptor's token count in the traffic's table
(``traffic/<traffic>.json``), uniform in [``ids.low``, the vocabulary),
padded with ``ids.pad`` on the left (the default side of the LLaMA and
Mistral tokenizers) to the call's longest row, with the attention mask
of the real tokens.  The pool holds ``pool_classes``
classes chosen by the seed, one from each equal share of the table's
classes ordered by their padded length, the shares taken in one fixed
order: every seed runs nearly the same sizes in the same order, on its
own classes and ids.  The window takes the pool's calls in turn:
``TextModel.encode_ids(ids, mask)`` and the copy of the pooled
[rows, width] features to the host, synchronous, as ``TextModel.encode``
does.  The tokenizer is left out: it is host work outside the program's
model, and its time would pace nothing on the card.

After the window a sample of the calls, drawn from the seed and always
holding the last, is compared with the plain reference's float32
features of the same ids and masks.
"""

from __future__ import annotations

import itertools
import json
import os
import time

import numpy as np
import torch

from port_bench import compare, flops, harness
from port_bench.reference import precision

SPAN = "port_bench.call"
GOLDEN = (5 ** 0.5 - 1) / 2


def table(wl) -> list:
    """The traffic's token counts, one list of ``rows`` a class."""
    path = os.path.join(harness.BENCH, "traffic", f"{wl['traffic']}.json")
    with open(path) as f:
        counts = json.load(f)["counts"]
    if any(len(c) != wl["rows"] for c in counts):
        raise SystemExit(f"port_bench: {path} holds classes of other than {wl['rows']} rows")
    return counts


def pool(wl, vocab: int, seed: int) -> list:
    """[(ids int64 [rows, T], mask int64 [rows, T], real tokens a row)]
    of the pool's calls, made on the host from the seed."""
    counts = table(wl)
    rng = np.random.default_rng(seed)
    order = sorted(range(len(counts)), key=lambda c: (max(counts[c]), sum(counts[c]), c))
    shares = np.array_split(order, wl["pool_classes"])
    # the shares in the golden ratio's order, so every stretch of calls
    # mixes short and long ones alike
    turn = sorted(range(len(shares)), key=lambda i: (i * GOLDEN) % 1.0)
    picked = [int(rng.choice(shares[i])) for i in turn]
    ids_of = wl["ids"]
    out = []
    for c in picked:
        lengths = [n + 1 for n in counts[c]]
        t = max(lengths)
        ids = np.full((len(lengths), t), ids_of["pad"], dtype=np.int64)
        mask = np.zeros((len(lengths), t), dtype=np.int64)
        for r, n in enumerate(lengths):
            ids[r, t - n:] = np.concatenate([[ids_of["bos"]], rng.integers(ids_of["low"], vocab, n - 1)])
            mask[r, t - n:] = 1
        out.append((ids, mask, lengths))
    return out


def encode(tm, call) -> np.ndarray:
    """One call through the program: its pooled features on the host."""
    ids, mask, _ = call
    return tm.encode_ids(ids, mask).cpu().numpy()


def reference(cfg, fam, seed, device, calls, picked, mm="fp32") -> torch.Tensor:
    """The plain reference's features [rows x len(picked), width] of the
    picked calls, from the seed's weights drawn anew."""
    sd = fam.state_dict(cfg, seed, device)
    with precision.strict_fp32():
        out = torch.cat([fam.reference_features(
            sd, torch.from_numpy(calls[j][0]).to(device), torch.from_numpy(calls[j][1]).to(device),
            cfg, precision.MATMULS[mm]).cpu() for j in picked])
    del sd
    harness.free(device)
    return out


def run(wl, cfg, fam, seed, seconds, trace, device, t0) -> dict:
    marks = {"imports": time.perf_counter() - t0}
    t = time.perf_counter()
    calls = pool(wl, fam.vocab(cfg), seed)
    marks["pool"] = time.perf_counter() - t
    t = time.perf_counter()
    sd = fam.state_dict(cfg, seed, device)
    tm = fam.build_text_model(cfg, sd, device)
    del sd
    harness.sync(device)
    marks["model"] = time.perf_counter() - t
    t = time.perf_counter()
    counts0 = fam.counters()
    # the longest calls: the allocator reaches its largest blocks
    warm = sorted(range(len(calls)), key=lambda j: -calls[j][0].shape[1])[:wl["warmup_calls"]]
    for j in warm:
        encode(tm, calls[j])
    route = harness.counter_delta(counts0, fam.counters(), len(warm))
    if trace:
        harness.warm_profiler(device)
    harness.reset_peak(device)
    marks["warm-up"] = time.perf_counter() - t
    start = time.perf_counter()
    setup_s = start - t0
    results = []
    while True:
        results.append(encode(tm, calls[len(results) % len(calls)]))
        if time.perf_counter() >= start + seconds:
            break
    span = time.perf_counter() - start
    peak = harness.peak_bytes(device)
    summary = None
    traced = calls[:wl["trace_calls"]]
    if trace:
        cycle = itertools.cycle(traced)
        summary = harness.trace_spans(lambda: encode(tm, next(cycle)), len(traced), SPAN,
                                      device)

    del tm
    harness.free(device)
    n = len(results)
    picked = compare.sample(seed, n, wl["check_calls"])
    want = reference(cfg, fam, seed, device, calls, [j % len(calls) for j in picked])
    numbers = compare.feature_numbers(
        torch.cat([torch.from_numpy(results[j]) for j in picked]).float(), want)

    peak_flops = flops.peak_flops(cfg["compute_dtype"])
    ops = [fam.forward_ops(cfg, c[2]) for c in calls]
    window = [flops.model_flops(ops[j % len(calls)]) for j in range(n)]
    real = sum(sum(c[2]) for c in calls)
    padded = sum(c[0].size for c in calls)
    return {
        "e2e": {"extract_text_rows_per_s": (n * wl["rows"] / span, "rows/s"),
                "setup_s": (setup_s, "s")},
        "attempted": n, "failed": 0,
        "numbers": numbers,
        "memory_peak_bytes": peak,
        "layer": {"kind": "text", "trace": summary, "steps": n, "window_s": span,
                  "model_flops": sum(window) / n, "peak_flops": peak_flops,
                  "least_s": sum(flops.least_seconds(ops[j], peak_flops)
                                 for j in range(len(traced))) / len(traced),
                  "route": route},
        "notes": ["[setup] " + ", ".join(f"{k} {v:.3f} s" for k, v in marks.items()),
                  f"[route] launches per call: {route}",
                  f"[calls] {n} in {span:.4f} s; pool of {len(calls)}: {real} real tokens "
                  f"in {padded} padded positions; compared calls {picked}",
                  f"[compare] mean feature gap {numbers['feature_gap_mean']}, widest "
                  f"{numbers['feature_gap']}"],
    }


def readings(wl, cfg, fam, seed, device, control: bool) -> list:
    """The program's features of ``check_calls`` calls of the pool drawn
    from the seed (as many as a run compares) against the reference; with
    ``control``, the reference with TF32 products (the control: float32's
    next step down) and the fault "pads counted in the mean" (the program's
    last hidden state pooled over every position of the padded rows)."""
    calls = pool(wl, fam.vocab(cfg), seed)
    picked = compare.sample(seed, len(calls), wl["check_calls"])
    sd = fam.state_dict(cfg, seed, device)
    tm = fam.build_text_model(cfg, sd, device)
    del sd
    got = {"program": torch.cat([torch.from_numpy(encode(tm, calls[j]))
                                 for j in picked])}
    if control:
        with torch.no_grad():
            got["fault_pads_counted"] = torch.cat([tm.model(
                torch.from_numpy(calls[j][0]).to(device),
                torch.from_numpy(calls[j][1]).to(device)).float().mean(1).cpu()
                for j in picked])
    del tm
    harness.free(device)
    want = reference(cfg, fam, seed, device, calls, picked)
    if control:
        got["control_tf32"] = reference(cfg, fam, seed, device, calls, picked, mm="tf32")
    return [(name, compare.feature_numbers(f.float(), want)) for name, f in got.items()]
