"""The PyTorch port's train CLI for HTC with its semantic head, on the CPU
at the tiny size (``test_torch_mask_entry.py``'s check, in a file of its
own to keep each file's time short): 2 iterations from a synthetic COCO
set with 8-bit PNG stuff maps under ``seg_prefix``, and with
``--fake-data``, log every stage's mask loss and ``loss_semantic_seg``,
finite and positive.
"""
import pytest

from test_torch_mask_entry import HTC, mask_set, one_thread, train_cli_logs_mask_losses  # noqa: F401


@pytest.mark.parametrize("fake", [False, True], ids=["files", "fake_data"])
def test_htc_train_cli_logs_mask_losses(mask_set, tmp_path, fake):  # noqa: F811
    train_cli_logs_mask_losses(mask_set, tmp_path, HTC, fake)
