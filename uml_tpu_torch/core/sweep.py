"""YAML sweep expansion + array-job dispatch.

The reference's scale-out model is "one hparam combo = one independent
process, idempotent outputs" (finetune.py:531-556, features.py:305-331,
MultiBench/main.py:186-217, Gaussian_experiment/main.py:159-209): a YAML of
list-valued keys is expanded into a cartesian product and either all combos
run sequentially or ``SLURM_ARRAY_TASK_ID`` selects one.

We keep that exact contract (so sweep YAMLs and Slurm scripts keep working)
and generalize the index variable so combos can also be mapped onto
hosts outside Slurm (``UML_ARRAY_TASK_ID`` falls back to
``SLURM_ARRAY_TASK_ID``).
"""

from __future__ import annotations

import argparse
import os
import sys
from itertools import product
from typing import Any, Callable

import yaml


def expand_sweep(sweep_args: dict[str, Any]) -> list[dict[str, Any]]:
    """Cartesian product over list-valued YAML keys (scalars = singletons)."""
    if not sweep_args:
        return [{}]
    keys, values = zip(*sweep_args.items())
    return [
        dict(zip(keys, v))
        for v in product(*[v if isinstance(v, list) else [v] for v in values])
    ]


def load_sweep(config_path: str) -> list[dict[str, Any]]:
    with open(config_path, "r") as f:
        sweep_args = yaml.load(f, Loader=yaml.FullLoader)
    return expand_sweep(sweep_args)


def array_task_id() -> int:
    """Index of this process in the array job (-1 if not in one)."""
    for var in ("UML_ARRAY_TASK_ID", "SLURM_ARRAY_TASK_ID"):
        v = os.getenv(var)
        if v is not None:
            return int(v)
    return -1


def apply_combo(parser: argparse.ArgumentParser, combo: dict[str, Any]):
    """Inject a sweep combo into an argparse parser.

    Matches the reference's ``parser.parse_args([], Namespace(**combo))``
    trick (finetune.py:548): defaults fill the gaps and combo keys that are
    *not* declared in the parser still land on the namespace (the reference
    relies on this for ``text_batch_size`` / ``return_tokens``).
    """
    return parser.parse_args([], argparse.Namespace(**combo))


def run_sweep_cli(
    main_fn: Callable[[argparse.Namespace], Any],
    inner_parser: argparse.ArgumentParser,
    description: str = "",
    default_config: str = "config.yaml",
    extra_outer_flags: Callable[[argparse.ArgumentParser], None] | None = None,
    require_run_flag: bool = False,
) -> None:
    """Two-stage CLI runner shared by every entrypoint.

    Outer flags (parity with finetune.py:513-520):
      -c/--config YAML, -s/--slurm, -d/--debug (parse remaining args
      directly), -f/--flag (run despite existing dir), -o/--overwrite.
    """
    outer = argparse.ArgumentParser(description=description)
    outer.add_argument("-c", "--config", type=str, default=default_config)
    outer.add_argument("-s", "--slurm", action="store_true",
                       help="array-job mode: run the combo selected by "
                            "UML_ARRAY_TASK_ID / SLURM_ARRAY_TASK_ID")
    outer.add_argument("-d", "--debug", action="store_true",
                       help="parse remaining args directly, no YAML sweep")
    outer.add_argument("-f", "--flag", action="store_true",
                       help="run despite existing experiments directory")
    outer.add_argument("-o", "--overwrite", action="store_true")
    if require_run_flag:
        outer.add_argument("-r", "--run", action="store_true",
                           help="actually run the experiments")
    if extra_outer_flags is not None:
        extra_outer_flags(outer)
    outer_args, remaining = outer.parse_known_args()

    def finalize(args):
        args.overwrite = outer_args.overwrite
        args.force_rerun = outer_args.flag
        return args

    if outer_args.debug:
        print("Running command-line arguments...")
        runs = [finalize(inner_parser.parse_args(remaining))]
    else:
        combos = load_sweep(outer_args.config)
        print("Total combinations:", len(combos))
        for i, combo in enumerate(combos):
            print(f"Combination {i}: {combo}")

        if require_run_flag and not outer_args.run:
            print("use -r to run experiments")
            sys.exit(0)

        if outer_args.slurm:
            job_id = array_task_id()
            if job_id < 0 or job_id >= len(combos):
                print("Invalid array task id")
                sys.exit(1)
            print(f"=> Running combination {job_id}: {combos[job_id]}")
            runs = [finalize(apply_combo(inner_parser, combos[job_id]))]
        else:
            runs = [finalize(apply_combo(inner_parser, combo)) for combo in combos]

    # --mesh auto over several cards: one process per card runs this
    # command line (core.meshes); this one waits for them and exits
    if any(hasattr(args, "mesh") for args in runs):
        from uml_tpu_torch.core.meshes import launch_per_card

        launch_per_card([getattr(args, "mesh", "off") for args in runs])
    for i, args in enumerate(runs):
        if not outer_args.debug and not outer_args.slurm:
            print(f"=> Running job {i}")
            print(args)
        main_fn(args)
