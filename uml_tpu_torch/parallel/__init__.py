from uml_tpu_torch.parallel.data_parallel import dp_shardings, make_dp_train_step
from uml_tpu_torch.parallel.tensor_parallel import (
    apply_tp_sharding,
    infer_sharding_tree,
    transformer_tp_rules,
)

__all__ = [
    "make_dp_train_step",
    "dp_shardings",
    "transformer_tp_rules",
    "apply_tp_sharding",
    "infer_sharding_tree",
]
