"""One train step per model family, the port against the JAX package, at
tiny widths (``tests/torch_train_common.py``): the perspective nets (GN and
NF, 64x96 views), the normalizer-free UniFuse-class net and HoHoNet
(64x128 panoramas).  JAX's initial parameters are the port's (carried in
flax's layout); the same numpy batch goes through both; the loss, the
gradients' global norm, the whole gradient and every leaf's gradient are
compared, then the port's step is taken.

Bars (relative; why they differ by family: torch_train_common's note):
f32 loss 1e-5 everywhere; the gradients 1e-4 (whole and per leaf) for the
perspective nets, per leaf 5e-3 for the NF UniFuse-class net (measured
1.3e-3) and 1e-3 for HoHoNet (1.6e-4), whole 1e-4 for both (9.6e-6,
4.8e-5).  bf16 (the nets' training type): loss 2e-3 (measured 8.3e-5),
whole gradient 0.1 (3.2e-2): each op rounds to bf16, and XLA keeps some
chains in f32 where PyTorch rounds each op.  The NF net's updated
parameters against optax's update of JAX's gradients
(``check_updated_leaves``): 99.9 % of the elements within 1e-6 + 1e-5 *
|p|, every one within 2 * lr.
"""

import pytest
import torch

from torch_train_common import check_step, check_updated_leaves

torch.set_num_threads(1)


@pytest.mark.parametrize("name,leaf_rel", [("perspective_gn", 1e-4),
                                           ("panoramic_nf", 5e-3),
                                           ("hohonet", 1e-3)])
def test_train_step_matches_jax_f32(name, leaf_rel):
    check_step(name, "f32", leaf_rel=leaf_rel)


def test_train_step_and_update_match_jax_f32_perspective_nf():
    jparams, jgrads, state, _, _ = check_step("perspective_nf", "f32")
    check_updated_leaves(jparams, jgrads, state, 0.999)


def test_train_step_matches_jax_bf16_perspective_nf():
    check_step("perspective_nf", "bf16", loss_rel=2e-3, leaf_rel=None,
               total_rel=0.1)
