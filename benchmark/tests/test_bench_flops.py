"""The frozen FLOP and byte counts against hand sums at small shapes."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.lib import flops


def test_lowrank_setup_flops_by_hand():
    # n = 3, m = 2, 1 excitation: chol 9, two triangular solves 2 * 9 * 3,
    # G and Q 2 * 2 * 3 * 4, chol(G) 8/3, projection 32, eigh 72, C^-T Z 8,
    # Q^T C0 2 * 3 * 2 * 1
    hand = 9 + 54 + 48 + 8 / 3 + 32 + 72 + 8 + 12
    assert flops.lowrank_setup_flops(3, 2, 1) == pytest.approx(hand)


def test_lowrank_setup_bytes_by_hand():
    # K_base 9, lung block 4, injections 3; s2 2, u0 2, yq 2, zq 4; float32
    assert flops.lowrank_setup_bytes(3, 2, 1, 2) == 4 * (9 + 4 + 3 + 2 + 2
                                                         + 2 + 4)


def test_lowrank_solve_flops_by_hand():
    assert flops.lowrank_solve_flops(100, 3, 208) == 2 * 100 * 3 * 208


def test_the_counts_grow_with_the_subject_not_its_padding():
    assert flops.lowrank_setup_flops(2200, 700, 16) < \
        flops.lowrank_setup_flops(3072, 768, 16)


def test_train_flops_match_flop_counter_mode():
    torch.manual_seed(0)
    net = torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3, 2, 1), torch.nn.Conv2d(8, 8, 3, 1, 1,
                                                        groups=8),
        torch.nn.ConvTranspose2d(8, 4, 2, 2), torch.nn.Flatten(),
        torch.nn.Linear(4 * 16 * 16, 5))
    x = torch.randn(2, 3, 16, 16)
    a, b = torch.randn(3, 4, 5), torch.randn(3, 5, 6)
    counts = []
    for mode in (FlopCounterMode(display=False), flops.TrainFlops()):
        with mode:
            net(x).sum().backward()
            torch.einsum("bij,bjk->bik", a, b)
        counts.append(float(mode.get_total_flops()) if isinstance(
            mode, FlopCounterMode) else mode.flops)
    assert counts[0] == counts[1] > 0


def test_conv_flops_by_hand():
    # 1 x 2 x 4 x 4 in, 3 x 2 x 3 x 3 kernel, 4 x 4 out: 2 * 16 * 9 * 3 * 2
    assert flops._conv_flops([1, 2, 4, 4], [3, 2, 3, 3], [1, 3, 4, 4],
                             False) == 2 * 16 * 9 * 3 * 2
