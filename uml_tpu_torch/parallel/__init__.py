from uml_tpu_torch.parallel.data_parallel import dp_shardings, make_dp_train_step

__all__ = [
    "make_dp_train_step",
    "dp_shardings",
]
