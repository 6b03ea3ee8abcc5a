"""``uml_tpu_torch.graft_entry`` against ``__graft_entry__.py`` on the CPU.

* ``entry()``: the same 8 uint8 images (numpy seed 0) and, with
  uml_tpu's random ViT-B/16 weights carried across
  (``convert.state_dict_from_jax``), the same bf16 image features on the
  first two of them: per-row cosine >= 0.9999 and max |port - uml_tpu|
  <= 2^-5 max |uml_tpu| (measured 0.99995 and 2^-6.7: bf16 through 12
  layers, rounded at different points by the two packages).
* ``dryrun_multichip(4)``: four gloo processes, a (2 data x 2 model) mesh;
  every leg prints its ok line and the call returns (a failing rank
  raises).
"""

import jax
import numpy as np
import torch

import __graft_entry__ as jax_graft
from uml_tpu_torch import graft_entry
from uml_tpu_torch.models.convert import state_dict_from_jax

ENTRY_MIN_COS = 0.9999
ENTRY_REL = 2.0 ** -5
LEGS = ("loss=", "int8 extraction over the mesh ok", "fused half-blocks",
        "seq-UML dp step", "finetune CLI e2e over 4 ranks")


def test_entry_matches_uml_tpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        _entry_matches_uml_tpu()
    finally:
        torch.set_num_threads(threads)


def _entry_matches_uml_tpu():
    jfn, (variables, jimages) = jax_graft.entry()
    fn, (model, images) = graft_entry.entry(device="cpu")
    assert images.dtype == torch.uint8 and tuple(images.shape) == (8, 224, 224, 3)
    np.testing.assert_array_equal(images.numpy(), np.asarray(jimages))
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    want = np.asarray(jax.jit(jfn)(variables, jimages[:2]), np.float32)
    got = fn(model, images[:2])
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 512)
    got = got.numpy()
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= ENTRY_MIN_COS, cos
    assert np.abs(got - want).max() <= ENTRY_REL * np.abs(want).max()


def test_dryrun_multichip_passes_every_leg(capfd):
    graft_entry.dryrun_multichip(4)
    out = capfd.readouterr().out
    lines = [line for line in out.splitlines() if line.startswith("dryrun_multichip(4)")]
    assert len(lines) == len(LEGS), lines
    for leg, line in zip(LEGS, lines):
        assert leg in line and line.endswith("ok"), line
    assert "mesh={'data': 2, 'model': 2}" in lines[0]
