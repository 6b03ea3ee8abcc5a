"""Kernels, the routed experts' grouped products (csrc/moe_gemm.cu through
ops/moe_gemm.py::moe_gemm): the least time of the traced calls' work in
them, the larger of its operations at the run's peak and its bytes at
3.35 TB/s (every expert's weights read once a launch, the rows in and out
once), over the device time of the kernels named ``moe_gemm_kernel`` in
the traced calls.

The weights' bytes are the program's count, the same in every call.  The
rows' operations and bytes are the program's count over the warm-up calls,
scaled to the traced calls' own rows: each launch's grid holds
ceil(R / 64) + G row tiles (``moe_gemm.tiles`` and ``moe_gemm.groups``
count the same of the warm-up launches), so the traced kernels' grids
give their rows to within one tile a launch.  Moves
extract_text_rows_per_s."""

from port_bench import flops, trace

UNIT = "%"
KERNEL = "moe_gemm_kernel"
KEYS = ("moe_gemm_flops", "moe_gemm_bytes", "moe_gemm_weight_bytes", "moe_gemm_tiles",
        "moe_gemm_groups")


def read(run):
    route, t = run.get("route") or {}, run.get("trace")
    if run.get("kind") != "text" or any(k not in route for k in KEYS) or not t \
            or not t.get("device_trace") or route["moe_gemm_tiles"] <= route["moe_gemm_groups"]:
        return None
    events = t["device_trace"]["traceEvents"]
    busy = [(s, e) for s, e, name, cat, _ in trace.device_events(events)
            if cat == "kernel" and KERNEL in name]
    grids = [(e.get("args") or {}).get("grid") for e in events
             if e.get("ph") == "X" and e.get("cat") == "kernel" and KERNEL in e.get("name", "")]
    if not busy or any(not g for g in grids):
        return None
    tiles = sum(g[0] for g in grids) / t["n_spans"]
    share = (tiles - route["moe_gemm_groups"]) / (route["moe_gemm_tiles"] - route["moe_gemm_groups"])
    weights = route["moe_gemm_weight_bytes"]
    least = max(route["moe_gemm_flops"] * share / run["peak_flops"],
                (weights + (route["moe_gemm_bytes"] - weights) * share) / flops.HBM_BYTES_PER_S)
    return 100.0 * least * t["n_spans"] / (trace.union_us(busy) / 1e6)
