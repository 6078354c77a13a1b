"""The area attention's operation and byte counts (``lib/area_attn.py``)
against hand sums at a small shape, and the YOLO12 driver's planted
faults changing what they say they change."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.drivers import yolo12_train
from benchmark.lib import area_attn
from benchmark.lib.manifest import Cell, manifest


def test_aattn_forward_by_hand():
    # B 1, d 4, a 2x2 map, 2 heads, 2 areas: N 4, n 2
    # qkv 2*4*4*12 = 384, scores 2*4*2*4 = 64, values 64, pe 2*4*49*4 =
    # 1568, sum 16, proj 2*4*4*4 = 128, BatchNorms 6*4*(12+4+4) = 480;
    # scores 1*2*2*2*2 = 16, scaled and softmaxed 6 each = 96
    flops, nbytes = area_attn.aattn_forward(1, 4, 2, 2, 2, 2)
    assert flops == 384 + 64 + 64 + 1568 + 16 + 128 + 480 + 96
    # x in 16 and out 16; kernels 48 + 196 + 16, BatchNorms 2 * 20
    assert nbytes == 4 * (16 + 16 + 48 + 196 + 16 + 40)


def test_the_products_are_flop_counter_modes():
    """The count less its elementwise terms equals torch's count of the
    port's AAttn forward (convolutions and matrix products)."""
    from eitx_torch.models.yolo.blocks import AAttn

    b, d, h, w, heads, area = 2, 64, 8, 6, 2, 4
    m = AAttn(d, heads, area).train()
    mode = FlopCounterMode(display=False)
    with mode, torch.no_grad():
        m(torch.randn(b, d, h, w))
    n_tok = h * w
    elementwise = b * n_tok * (d + area_attn.BN_OPS * 5 * d) + (
        b * area * heads * (n_tok // area) ** 2 * (1 + area_attn.SOFTMAX_OPS))
    flops, _ = area_attn.aattn_forward(b, d, h, w, heads, area)
    assert flops - elementwise == mode.get_total_flops()


def test_the_cell_counts_sixteen_aattns():
    cfg = Cell("train-tissue-y12l-n512-b16", manifest()).config
    flops, nbytes = area_attn.network_area_attn(cfg, 16, 512)
    p4 = area_attn.aattn_forward(16, 256, 32, 32, 8, 4)
    p5 = area_attn.aattn_forward(16, 256, 16, 16, 8, 1)
    assert flops == 8 * (p4[0] + p5[0]) and nbytes == 8 * (p4[1] + p5[1])
    assert 8.3e9 < flops / 16 < 8.8e9  # a forward's attention, an image


def _attns(model):
    return {n: m for n, m in model.named_modules()
            if type(m).__name__ == "AAttn"}


@pytest.mark.parametrize("fault", ["area_whole", "no_pe"])
def test_the_attention_faults_change_what_they_say(fault):
    """``area_whole``: layer 6's AAttns (4 stripes) attend over the whole
    map, layer 8's are left alone; ``no_pe``: every position perceiver
    gives 0 and every area stays. Either way the network's output moves."""
    from eitx_torch.models.yolo.init import yolo12_init_model
    from eitx_torch.models.yolo.model import yolov12_spec

    sound = yolo12_init_model(yolov12_spec("n", nc=4), 0).train()
    model = yolo12_init_model(yolov12_spec("n", nc=4), 0).train()
    yolo12_train.plant(model, fault)
    areas = {n: m.area for n, m in _attns(sound).items()}
    assert {areas[n] for n in areas if n.startswith("model.6.")} == {4}
    for n, m in _attns(model).items():
        whole = fault == "area_whole" and n.startswith("model.6.")
        assert m.area == (1 if whole else areas[n]), n
        x = torch.randn(1, m.pe.conv.in_channels, 4, 4)
        assert bool((m.pe(x) == 0).all()) == (fault == "no_pe"), n
    img = torch.rand(2, 3, 64, 64)
    with torch.no_grad():
        assert not torch.equal(model(img)["proto"], sound(img)["proto"])


def test_the_pooled_gap_is_one_vector():
    """``pooled_gap`` is norm(prog - ref) / norm(ref) over the leaves
    joined: a 2x change of a leaf holding a fifth of the squared norm reads
    sqrt(1/5); a leaf left out changes nothing; equal inputs read 0."""
    ref = {"a": torch.full((4,), 1.0), "b": torch.full((16,), 1.0),
           "c": torch.full((3,), 5.0)}
    prog = dict(ref, a=2 * ref["a"], c=-ref["c"])
    assert yolo12_train.pooled_gap(ref, ref, ["a", "b", "c"]) == 0.0
    got = yolo12_train.pooled_gap(prog, ref, ["a", "b"])
    assert abs(got - (4 / 20) ** 0.5) < 1e-12

