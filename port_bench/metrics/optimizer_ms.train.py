"""Train loop (train/optim.py, torch AdamW, called from make_train_step):
device ms a step of the kernels launched inside torch.optim's
``Optimizer.`` annotations (step and zero_grad).  Moves
train_samples_per_s."""

from port_bench.metrics._common import split_ms

UNIT = "ms"


def read(run):
    return split_ms(run, "train", "optimizer")
