"""Model + autograd (the ops' Function backwards, mlp_bwd_via_stash, _vjp):
device ms a step of the kernels launched inside autograd's
evaluate_function ranges.  Moves train_samples_per_s."""

from port_bench.metrics._common import split_ms

UNIT = "ms"


def read(run):
    return split_ms(run, "train", "backward")
