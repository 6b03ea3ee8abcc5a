"""Few-shot split generator CLI.

Flag/behavior parity with vision_language/generate_fewshot.py:13-38: writes
``<indices_dir>/<dataset>/shot_{n}-seed_{s}.json`` (skip if it exists),
sampling with the seeded global RNG so output is byte-identical to the
reference for the same dataset + seed.
"""

from __future__ import annotations

import argparse
import os

from uml_tpu_torch.core.sweep import run_sweep_cli
from uml_tpu_torch.data.benchmarks import generate_fewshot_dataset
from uml_tpu_torch.data.fewshot import get_few_shot_setup_name
from uml_tpu_torch.data.registry import dataset_classes
from uml_tpu_torch.utils.io import makedirs, save_as_json
from uml_tpu_torch.utils.seeding import set_random_seed


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Few-shot split generator")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--indices_dir", type=str, required=True)
    p.add_argument("--dataset", type=str, default="fgvc_aircraft",
                   choices=list(dataset_classes.keys()))
    p.add_argument("--train-shot", type=int, default=1, dest="train_shot")
    p.add_argument("--max-val-shot", type=int, default=4, dest="max_val_shot")
    p.add_argument("--seed", type=int, default=1)
    return p


def main(args: argparse.Namespace):
    if args.seed >= 0:
        print(f"Setting fixed seed: {args.seed}")
        set_random_seed(args.seed)

    assert args.dataset in dataset_classes
    index_file = os.path.join(
        args.indices_dir,
        args.dataset,
        get_few_shot_setup_name(args.train_shot, args.seed) + ".json",
    )
    if os.path.exists(index_file):
        print(f"Few-shot data exists at {index_file}.")
        return index_file
    print(f"Few-shot data does not exist at {index_file}. Sample a new split.")
    makedirs(os.path.dirname(index_file))
    benchmark = dataset_classes[args.dataset](args.data_dir)
    few_shot_dataset = generate_fewshot_dataset(
        benchmark.train,
        benchmark.val,
        num_shots=args.train_shot,
        max_val_shots=args.max_val_shot,
    )
    save_as_json(few_shot_dataset, index_file)
    print("Done!")
    return index_file


if __name__ == "__main__":
    run_sweep_cli(main, build_parser(), description="Few-shot split generator")
