#!/usr/bin/env python3
"""How far does torch.optim.Adam's capturable form move the Gaussian run?

A CUDA graph can hold Adam's step only in its ``capturable=True`` form,
which computes the bias corrections in fp32 tensors; the eager form
computes them in Python floats.  This trains the Gaussian experiment at
the paper's setting (configs/gaussian.yaml, seed 0, mode xy) for 200
steps from one init and one index stream on the CPU, once with each
form, and prints the largest relative difference of every logged metric
(train/gaussian.py stepped Adam eagerly between its graphs after this).

    python3 tools/exp_torch_gaussian_adam.py [steps]

Runs on the CPU (the capturable form is allowed there for the check).
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, HERE)
    os.environ["UML_TORCH_DEVICE"] = "cpu"
    import numpy as np
    import torch
    import torch.optim.adam as adam

    import chip_smoke as cs
    from uml_tpu_torch.train import gaussian

    steps = int(sys.argv[1]) if len(sys.argv) > 1 else cs.GAUSSIAN_CPU_STEPS
    cs.GAUSSIAN_CPU_STEPS = steps
    args = cs._gaussian_paper_args(os.path.join(HERE, "build", "exp_gaussian_adam"))
    eager = cs._gaussian_history(args, "cpu")

    eager_adam = torch.optim.Adam

    class CapturableAdam(eager_adam):
        def __init__(self, *a, **kw):
            super().__init__(*a, capturable=True, foreach=True, **kw)

    adam._get_capturable_supported_devices = lambda supports_xla=True: ["cpu", "cuda"]
    gaussian.torch.optim.Adam = CapturableAdam
    try:
        capturable = cs._gaussian_history(args, "cpu")
    finally:
        gaussian.torch.optim.Adam = eager_adam
    print(f"{steps} steps on the CPU ({torch.get_num_threads()} threads), "
          f"capturable against eager Adam, max |difference|:")
    for key in sorted(eager):
        diff = np.abs(capturable[key] - eager[key])
        rel = diff / np.maximum(np.abs(eager[key]), 1e-30)
        print(f"  {key:12s} relative {float(rel.max()):.4e}  absolute {float(diff.max()):.4e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
