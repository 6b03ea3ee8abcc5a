from uml_tpu_torch.utils.io import (
    makedirs,
    load_json,
    save_as_json,
    load_pickle,
    save_pickle,
    check_isfile,
    listdir_nohidden,
    Tee,
)
from uml_tpu_torch.utils.seeding import set_random_seed, cname2lab

__all__ = [
    "makedirs",
    "load_json",
    "save_as_json",
    "load_pickle",
    "save_pickle",
    "check_isfile",
    "listdir_nohidden",
    "Tee",
    "set_random_seed",
    "cname2lab",
]
