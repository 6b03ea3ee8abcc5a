"""CLI entrypoint for the synthetic Gaussian UML experiment.

The port of uml_tpu/cli/gaussian.py, flag for flag (Gaussian_experiment/
main.py:152-209: the same inner flags, the same -c/-s/-r outer contract,
the same YAML sweep expansion), so configs/gaussian.yaml and the
configs/gaussian_ablations/ sweeps run unchanged:

    python -m uml_tpu_torch.cli.gaussian -c configs/gaussian.yaml -r
    UML_ARRAY_TASK_ID=3 python -m uml_tpu_torch.cli.gaussian -c train.yaml -r -s
    UML_TORCH_DEVICE=cpu python -m uml_tpu_torch.cli.gaussian -d --num_steps 200

Data seeding contract (main.py:92-127): train pool from seed 42 (gaussian),
second train pool from seed 44 (laplace), val from seed 43 (gaussian,
no attenuation).  mode 'xy' splits the sample budget half X / half Y;
``--unrelated_info`` sources Y from the second (unrelated) pool.  It runs
on the card (core.device.default_device; ``UML_TORCH_DEVICE=cpu`` asks for
the CPU); ``--debug_nans`` raises at the first step whose loss is not
finite.  Each run writes ``metrics.jsonl`` and ``results.json`` under
``<outdir>/mode_<m>-seed_<s>-tag_<t>`` and is skipped when its
``results.json`` exists (-f / -o rerun it).
"""

from __future__ import annotations

import argparse
import json
import os

from uml_tpu_torch.core.device import default_device
from uml_tpu_torch.core.sweep import run_sweep_cli
from uml_tpu_torch.data.gaussian import generate_data
from uml_tpu_torch.train.gaussian import make_model, train_gaussian
from uml_tpu_torch.utils.logging import init_logger
from uml_tpu_torch.utils.seeding import set_random_seed


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Synthetic Gaussian UML experiment")
    p.add_argument("--dim_obs", type=int, default=50)
    p.add_argument("--dim_common", type=int, default=100)
    p.add_argument("--dim_latent", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--num_steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--data_dim_common", type=int, default=5)
    p.add_argument("--data_dim_x", type=int, default=10)
    p.add_argument("--data_dim_y", type=int, default=10)
    p.add_argument("--noise_std", type=float, default=0.1)
    p.add_argument("--train_num_samples", type=int, default=100000)
    p.add_argument("--val_num_samples", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--alpha_x", type=float, default=1.0)
    p.add_argument("--alpha_y", type=float, default=1.0)
    p.add_argument("--mode", type=str, default="xy", choices=["xy", "x"])
    p.add_argument("--tag", type=str, default="default")
    p.add_argument("--attenuation", type=float, default=0.05)
    p.add_argument("--unrelated_info", action="store_true")
    p.add_argument("--debug_nans", action="store_true", default=False,
                   help="raise at the first step whose loss is not finite")
    p.add_argument("--outdir", type=str, default="results/gaussian",
                   help="where to write metrics.jsonl / results.json")
    return p


def main(args: argparse.Namespace):
    def dgp(seed, n, attenuate, dist):
        return generate_data({
            "seed": seed,
            "num_samples": n,
            "dim_c": args.data_dim_common,
            "dim_x": args.data_dim_x,
            "dim_y": args.data_dim_y,
            "dim_obs": args.dim_obs,
            "noise_std": args.noise_std,
            "attenuate_x": attenuate,
            "attenuation": args.attenuation,
            "shared_latent_distribution_type": dist,
        })

    train_data = dgp(42, args.train_num_samples, True, "gaussian")
    train_data2 = dgp(44, args.train_num_samples, True, "laplace")
    val_data = dgp(43, args.val_num_samples, False, "gaussian")

    n = args.train_num_samples
    if args.mode == "xy":
        y_src = train_data2 if args.unrelated_info else train_data
        pools = {"x": train_data["x"][: n // 2], "y": y_src["y"][: n - n // 2]}
    else:
        pools = {"x": train_data["x"], "y": train_data2["y"]}

    set_random_seed(args.seed)

    run_name = f"mode_{args.mode}-seed_{args.seed}-tag_{args.tag}"
    outdir = os.path.join(args.outdir, run_name)
    results_path = os.path.join(outdir, "results.json")
    if os.path.exists(results_path) and not (
        getattr(args, "overwrite", False) or getattr(args, "force_rerun", False)
    ):
        print(f"=> Skipping {outdir} as results exist (use -f/-o to rerun)")
        with open(results_path) as f:
            return json.load(f)
    logger = init_logger("Gaussian_experiments", config=vars(args),
                         tags=[args.mode, args.tag], logdir=outdir)

    model = make_model(args.dim_obs, args.dim_common, args.dim_latent)
    result = train_gaussian(
        model,
        pools,
        val_data["x"],
        val_data["y"],
        mode=args.mode,
        alpha_x=args.alpha_x,
        alpha_y=args.alpha_y,
        lr=args.lr,
        batch_size=args.batch_size,
        num_steps=args.num_steps,
        seed=args.seed,
        logger=logger,
        device=default_device(),
        check_finite=args.debug_nans,
    )
    if hasattr(logger, "finish"):
        logger.finish()

    summary = {
        "mode": args.mode,
        "seed": args.seed,
        "val_loss_x": result.final_val_loss_x,
        "val_loss_y": result.final_val_loss_y,
        "val_cka": result.final_cka,
        "val_mknn": result.final_mknn,
        "num_steps": args.num_steps,
    }
    os.makedirs(outdir, exist_ok=True)
    with open(results_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(
        f"=> [{run_name}] val_loss_x={result.final_val_loss_x:.6f} "
        f"val_loss_y={result.final_val_loss_y:.6f} "
        f"cka={result.final_cka:.4f} mknn={result.final_mknn:.4f}"
    )
    return summary


if __name__ == "__main__":
    run_sweep_cli(
        main,
        build_parser(),
        description="Synthetic Gaussian UML experiment",
        default_config="train.yaml",
        require_run_flag=True,
    )
