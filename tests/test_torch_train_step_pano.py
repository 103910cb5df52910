"""One train step per model family, the port against the JAX package, at
tiny widths (``tests/torch_train_common.py``): the GN UniFuse-class net,
BiFuse, SliceNet and FastPanoNet (64x128 panoramas), and FastPanoNet's
updated parameters against optax's update of JAX's gradients.

Bars (relative; why they differ by family: torch_train_common's note):
f32 loss 1e-5 everywhere; per leaf 0.15 for the GN UniFuse-class net
(measured 6.0e-2), 1e-3 for BiFuse (2.8e-4), 1e-2 for SliceNet (2.2e-3),
3e-2 for FastPanoNet (8.0e-3); the whole gradient 1e-2 (UniFuse-class
6.3e-3, SliceNet 1.0e-3, FastPanoNet 1.8e-3), 1e-4 for BiFuse (2.4e-5).
bf16 FastPanoNet: loss 2e-3 (measured 5.1e-4), whole gradient 0.25 (0.12).
Updated leaves (``check_updated_leaves``): 99 % of FastPanoNet's
elements within 1e-6 + 1e-5 * |p| of JAX's: its gradients differ by up
to 8e-3 on a leaf, and Adam's first step moves an element by lr * g /
(|g| + 1e-8), the sign of a small g.
"""

import pytest
import torch

from torch_train_common import check_step, check_updated_leaves

torch.set_num_threads(1)


@pytest.mark.parametrize("name,leaf_rel,total_rel", [
    ("panoramic_gn", 0.15, 1e-2), ("bifuse", 1e-3, 1e-4),
    ("slicenet", 1e-2, 1e-2)])
def test_train_step_matches_jax_f32(name, leaf_rel, total_rel):
    check_step(name, "f32", leaf_rel=leaf_rel, total_rel=total_rel)


def test_fastpano_step_and_update_match_jax():
    jparams, jgrads, state, _, _ = check_step(
        "fastpano", "f32", leaf_rel=3e-2, total_rel=1e-2)
    check_updated_leaves(jparams, jgrads, state, 0.99)


def test_train_step_matches_jax_bf16_fastpano():
    check_step("fastpano", "bf16", loss_rel=2e-3, leaf_rel=None,
               total_rel=0.25)
