"""``tools/parity_baseline_torch.py --dry_run --skip_gaussian`` on the CPU:
the synthetic caltech fixture through the port's generate_fewshot ->
features -> finetune with a random-init ViT-B/16 and the smoke grid,
run as a user runs it (a fresh interpreter, ``UML_TORCH_DEVICE=cpu``):
exit code 0, its OK line and a test accuracy in [0, 1]."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dry_run_completes(tmp_path):
    env = dict(os.environ, UML_TORCH_DEVICE="cpu", USE_TF="0", TMPDIR=str(tmp_path))
    env.pop("UML_CLIP_WEIGHTS_DIR", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "parity_baseline_torch.py"),
         "--dry_run", "--skip_gaussian"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "[dry-run] plumbing OK" in proc.stdout
    acc = re.search(r"\[caltech101\] 3-shot crossmodal: val ([0-9.]+) test ([0-9.]+)",
                    proc.stdout)
    assert acc and 0.0 <= float(acc.group(2)) <= 1.0, proc.stdout[-2000:]
    assert not os.listdir(tmp_path) or all(not d.startswith("uml_parity_dry_")
                                           for d in os.listdir(tmp_path))
