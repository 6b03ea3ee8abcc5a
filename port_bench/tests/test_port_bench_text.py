"""The text cell's traffic and its readers, on the CPU."""

import numpy as np
import pytest

from port_bench import flops, harness
from port_bench.drivers import extract_text

CELL = "mistral_7b.text_cupl30"


def read(name, run):
    return harness.metric_readers()[name].read(run)


def text_run(**trace):
    return {"kind": "text", "steps": 150, "window_s": 50.0, "model_flops": 8.0e12,
            "peak_flops": flops.PEAK_TF32_FLOPS, "least_s": 0.018,
            "trace": {"n_spans": 10, "busy_s": 3.0, "window_s": 3.2, "kernel_s": 2.9,
                      **trace}}


def test_text_readers_on_a_synthetic_run():
    got = {name: read(name, text_run()) for name in (
        "forward_ms.text", "forward_roofline.text", "mfu.text", "device_idle_share.text")}
    assert got == pytest.approx({
        "forward_ms.text": 290.0,                       # 2.9 s of kernels over 10 calls
        "forward_roofline.text": 100 * 0.018 * 10 / 3.0,
        "mfu.text": 100 * 8.0e12 * 150 / (50.0 * 494.7e12),
        "device_idle_share.text": 100 * (1 - 3.0 / 3.2)})
    # the other cells' readers find nothing in a text run, and these
    # nothing in theirs
    others = {name: m.read(text_run()) for name, m in harness.metric_readers().items()
              if not name.endswith(".text")}
    assert set(others.values()) == {None}
    assert read("mfu.text", {**text_run(), "kind": "extract"}) is None
    assert read("forward_ms.text", {**text_run(), "trace": None}) is None


def test_rows_are_left_padded_with_a_bos_first():
    wl = harness.workload(CELL)
    counts = extract_text.table(wl)
    calls = extract_text.pool(wl, 32000, 2**31 + 5)
    assert len(calls) == wl["pool_classes"] == 64
    for ids, mask, lengths in calls:
        assert ids.shape == mask.shape == (30, max(lengths))
        assert mask.sum(1).tolist() == lengths
        assert sorted(n - 1 for n in lengths) in [sorted(c) for c in counts]
        for r, n in enumerate(lengths):
            t = ids.shape[1]
            assert (mask[r, t - n:] == 1).all() and (mask[r, :t - n] == 0).all()
            assert ids[r, t - n] == 1 and (ids[r, :t - n] == 2).all()
            assert ((ids[r, t - n + 1:] >= 3) & (ids[r, t - n + 1:] < 32000)).all()


def test_every_seed_runs_nearly_the_same_sizes():
    """One class from each 64th of the classes ordered by padded length,
    the 64ths in one order: the padded positions of a pool move by well
    under a percent, and the calls' lengths, in turn, by a token or two."""
    wl = harness.workload(CELL)
    pools = [extract_text.pool(wl, 32000, seed)
             for seed in (1, 2, 3, 3_000_000_017, 4_000_000_001)]
    padded = [sum(ids.size for ids, _, _ in p) for p in pools]
    assert max(padded) / min(padded) < 1.01
    t = np.array([[ids.shape[1] for ids, _, _ in p] for p in pools])
    assert np.median(t.max(0) - t.min(0)) == 0 and (t.max(0) - t.min(0)).max() <= 6
    a, b = (extract_text.pool(wl, 32000, seed) for seed in (1, 2))
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))
