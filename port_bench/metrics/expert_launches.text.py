"""Model forward, the MoE's expert products, counted where they are
launched (ops/moe_gemm.py: ``moe_gemm.launches`` on the card,
``moe_gemm_plain.launches`` off it): launches a call over the warm-up
calls, from the run's ``route``.  Moves extract_text_rows_per_s."""

UNIT = "launches"


def read(run):
    if run.get("kind") != "text":
        return None
    return (run.get("route") or {}).get("expert_launches")
