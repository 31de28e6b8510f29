"""The other half of ``test_torch_train_models.py``'s architectures: the
loss and every gradient leaf of ``Model.train_loss`` against the
reference's, at the limits stated there, and mixtral-8x22b in
bfloat16."""
import pytest

from test_torch_train_models import check_train_loss_and_grads

ARCHS_B = ("jamba-v0.1-52b", "gemma2-27b", "nemotron-4-15b",
           "paligemma-3b")


@pytest.mark.parametrize("aid", ARCHS_B)
def test_train_loss_and_grads_match_reference(aid):
    check_train_loss_and_grads(aid, "float32")


def test_train_loss_and_grads_bf16_within_tolerance_mixtral():
    check_train_loss_and_grads("mixtral-8x22b", "bfloat16")
