"""The serving segmenter in bfloat16: the port against eitx on the CPU,
layer by layer and end to end.

eitx runs the whole network in bfloat16 (variables and activations), and
XLA rounds each operation's float32 result to bfloat16. The port computes
the same operations in the same order (``models/yolo/rounding.py``,
``blocks.BatchNorm2d._eval_bf16``, ``blocks.Conv2d``), so every operation
but one equals eitx's to the bit. The one left is the convolution's
accumulation order: XLA:CPU sums a convolution in float32 strictly in
order over (kh, kw, cin), oneDNN (and cuDNN on the card) block the sum,
and the two round to a different bfloat16 on a few elements near a
rounding boundary. A one-ulp difference then travels: the layer walk below
holds each layer at the agreement measured on eitx's own inputs, and the
labels at the agreement measured end to end (0.99896 before the repair).
"""

import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eitx.core.config import ModelConfig
from eitx.models.yolo.infer import TissueSegmenter as EitxSegmenter
from eitx.models.yolo.model import YoloSpec as EitxSpec
from eitx.models.yolo.model import YoloV11 as EitxYolo
from eitx.models.yolo.post import postprocess_segment_labels as eitx_post
from eitx.train.phantoms import phantom_batch
from eitx_torch.models.yolo import blocks, rounding
from eitx_torch.models.yolo.checkpoint import flax_to_torch_state, load_state
from eitx_torch.models.yolo.infer import TissueSegmenter
from eitx_torch.models.yolo.model import YoloSpec, YoloV11
from eitx_torch.models.yolo.post import postprocess_segment_labels
from torch_bounds import bounded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_256 = os.path.join(ROOT, "weights", "tissue_n_256.msgpack")
BF16 = torch.bfloat16

# The share of a layer's elements equal to eitx's when the layer runs on
# eitx's own input (tissue_n_256, the 256 phantom, 4 flip views): measured
# with one torch thread, and the bound set a step below. Every difference
# is a convolution's accumulation order (module docstring).
LAYER_AGREEMENT = {
    # measured: 0.9999981 / 0.9999952 / 0.9999847 (1, 5 and 8 elements)
    1: 0.99999, 2: 0.99999, 3: 0.99998,
    4: 0.9995, 5: 0.9999, 6: 0.9995, 7: 0.9999, 8: 0.9999, 9: 0.9999,
    10: 0.98, 13: 0.998, 16: 0.998, 17: 0.9999, 19: 0.998, 20: 0.9999,
    22: 0.93,
    # the head on eitx's three features
    "box 0": 0.997, "box 1": 0.999, "box 2": 0.9999, "cls 0": 0.9999,
    "cls 1": 0.9999, "cls 2": 0.9999, "coef 0": 0.999, "coef 1": 0.9999,
    "coef 2": 0.9999, "proto": 0.997,
}
# the largest difference over the layer's scale, any layer (measured
# 5.5e-3 at layer 22): one bfloat16 ulp carried through a few layers
LAYER_DEV = 1e-2
# Labels of the serving request at 256: the repaired port's measured
# agreement (0.99968), never below the unrepaired port's 0.99896
LABEL_AGREEMENT = 0.9995


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the bounds were measured so (oneDNN's sums may
    block otherwise), and parallel test workers share the CPU."""
    # never set back above 1: a batched float32 linalg.solve (oneMKL)
    # later in the same worker can then hang
    torch.set_num_threads(1)


def _phantom_256():
    b = phantom_batch(1, 256, 12, np.random.default_rng(42))
    return (b["images"][0, ..., 0] * 255).astype(np.uint8)


def _nchw(a) -> torch.Tensor:
    """An NHWC jax array -> the same bfloat16 values in NCHW."""
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy()).to(BF16)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().transpose(0, 2, 3, 1)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def walk():
    """eitx's bfloat16 network on the serving canvas (4 flip views of the
    phantom) with every module's output, and the port's network."""
    ref = EitxSegmenter(256, weights=CKPT_256, dtype="bfloat16")
    got = TissueSegmenter(256, weights=CKPT_256, dtype="bfloat16",
                          device="cpu")
    x = jnp.repeat((jnp.asarray(_phantom_256(), jnp.bfloat16) / 255.0)
                   [None, ..., None], 3, axis=-1)
    x = jnp.concatenate([x, x[:, :, ::-1], x[:, ::-1], x[:, ::-1, ::-1]])

    @jax.jit
    def run(v, x):
        # the input of the attention's projection, ``out + pe``, which no
        # module returns
        proj_in = []

        def record(call, args, kwargs, context):
            if context.module.name == "proj":
                proj_in.append(args[0])
            return call(*args, **kwargs)

        with flax.linen.intercept_methods(record):
            out, state = ref.model.apply(
                v, x, train=False, capture_intermediates=True,
                mutable=["intermediates"])
        return out, state, proj_in[0]

    out, state, proj_in = run(ref.variables, x)
    return dict(x=x, out=out, inter=state["intermediates"], net=got.model,
                attention_out=proj_in)


def _output(inter, path):
    for key in filter(None, path.split("/")):
        inter = inter[key]
    return inter["__call__"][0]


def _layer_input(w, i):
    """The input eitx gave layer ``i`` (NHWC, bfloat16): the previous
    layer's output, or the PAN's concatenations."""
    if i == 0:
        return w["x"]
    o = lambda j: _output(w["inter"], f"model_{j}")  # noqa: E731
    up = lambda a: jnp.repeat(jnp.repeat(a, 2, 1), 2, 2)  # noqa: E731
    pairs = {13: lambda: (up(o(10)), o(6)), 16: lambda: (up(o(13)), o(4)),
             19: lambda: (o(17), o(13)), 22: lambda: (o(20), o(10))}
    return jnp.concatenate(pairs[i](), -1) if i in pairs else o(i - 1)


def _agreement(got: torch.Tensor, ref) -> tuple:
    """(share of equal elements, largest difference over the scale)."""
    ref = _f32(ref)
    got = _nhwc(got)
    return ((got == ref).mean(),
            np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("layer", [0, 1, 2, 3])
def test_layers_0_to_3_equal_eitx_to_the_bit(walk, layer, record_property):
    """On the straight view, layers 0-3 (Conv, Conv, C3k2, Conv) equal
    eitx's to the bit. On the three flipped views a convolution of layers
    1-3 rounds 1, 5 and 8 elements to the neighbouring bfloat16."""
    with torch.no_grad():
        got = walk["net"].model[layer](_nchw(_layer_input(walk, layer)))
    ref = _output(walk["inter"], f"model_{layer}")
    assert np.array_equal(_nhwc(got)[0], _f32(ref)[0])
    equal, dev = _agreement(got, ref)
    bounded(record_property, "max_dev_over_scale", dev, "<=", LAYER_DEV)
    bounded(record_property, "equal_share", equal, ">=",
            LAYER_AGREEMENT.get(layer, 1.0))


@pytest.mark.parametrize("layer", [4, 5, 6, 7, 8, 9, 10, 13, 16, 17, 19, 20,
                                   22])
def test_layer_on_eitx_input_at_its_bound(walk, layer, record_property):
    with torch.no_grad():
        got = walk["net"].model[layer](_nchw(_layer_input(walk, layer)))
    equal, dev = _agreement(got, _output(walk["inter"], f"model_{layer}"))
    bounded(record_property, "max_dev_over_scale", dev, "<=", LAYER_DEV)
    bounded(record_property, "equal_share", equal, ">=",
            LAYER_AGREEMENT[layer])


def _conv_blocks(tree, path=""):
    """Paths of every flax ``Conv`` block (a conv, a BatchNorm, maybe an
    activation) under ``tree``."""
    if "conv" in tree and "bn" in tree:
        yield path
    for key, sub in tree.items():
        if isinstance(sub, dict) and key not in ("conv", "bn"):
            yield from _conv_blocks(sub, f"{path}/{key}" if path else key)


def _port_module(net, flax_path):
    """The port's module of a flax path (``model_13/m_0/cv1`` ->
    ``model.13.m.0.cv1``; the head's ``cv3_1_0_1`` -> ``cv3.1.0.1``,
    ``proto_cv1`` -> ``proto.cv1``; a PSA block's ``ffn_0`` ->
    ``ffn.0``)."""
    mod = net
    for part in flax_path.split("/"):
        if part.startswith("model_"):
            mod = mod.model[int(part[6:])]
        elif part.startswith("proto_"):
            mod = getattr(mod.proto, part[6:])
        elif part.startswith("m_"):
            mod = mod.m[int(part[2:])]
        else:
            name, *idx = part.split("_")
            mod = getattr(mod, name)
            for i in idx:
                mod = mod[int(i)]
    return mod


@pytest.mark.parametrize("layer", list(range(11)) + [13, 16, 17, 19, 20, 22,
                                                      23])
def test_every_batchnorm_and_silu_equal_eitx_to_the_bit(walk, layer):
    """Each Conv block of the layer, from eitx's convolution output: the
    port's BatchNorm gives eitx's, and its activation eitx's block output
    (flax rounds each of the BatchNorm's five operations and SiLU's four;
    ``nn.BatchNorm2d`` and ``F.silu`` round once)."""
    tree = walk["inter"][f"model_{layer}"]
    paths = list(_conv_blocks(tree))
    assert paths
    for path in paths:
        block = _port_module(walk["net"], f"model_{layer}/{path}".rstrip("/"))
        conv = _output(tree, f"{path}/conv")
        bn = _output(tree, f"{path}/bn")
        with torch.no_grad():
            got_bn = block.bn(_nchw(conv))
            got = block.act(_nchw(bn))
        assert np.array_equal(_nhwc(got_bn), _f32(bn)), path
        assert np.array_equal(_nhwc(got), _f32(_output(tree, path))), path


def test_attention_equals_eitx_to_the_bit(walk):
    """Layer 10's attention from eitx's qkv and positional outputs: the
    scaled product, the softmax (the row sum of the float32 ``exp``, the
    rounded ``exp`` over it), the product with v and the positional add
    give eitx's ``out + pe``, the projection's input, to the bit."""
    tree = walk["inter"]["model_10"]["m_0"]["attn"]
    att = walk["net"].model[10].m[0].attn
    qkv = _nchw(_output(tree, "qkv"))
    b, c, h, w = qkv.shape[0], att.proj.conv.in_channels, *qkv.shape[2:]
    q, k, v = qkv.view(b, att.num_heads, att.key_dim * 2 + att.head_dim,
                       h * w).split([att.key_dim, att.key_dim, att.head_dim],
                                    dim=2)
    with torch.no_grad():
        a = rounding.einsum("bhcn,bhcm->bhnm", q, k) * rounding.constant(
            att.scale, BF16)
        x = rounding.einsum("bhcm,bhnm->bhcn", v, rounding.softmax(a, -1))
        x = x.reshape(b, c, h, w) + _nchw(_output(tree, "pe"))
    assert np.array_equal(_nhwc(x), _f32(walk["attention_out"]))


def test_head_on_eitx_features_at_its_bound(walk, record_property):
    """The detect / segment head on eitx's three features. Its last 1x1
    convolutions and the proto's transposed convolutions add their bias
    after the convolution rounds, as flax does (a fused bias rounds once:
    0.66-0.74 of the elements agreed)."""
    o = lambda j: _nchw(_output(walk["inter"], f"model_{j}"))  # noqa: E731
    with torch.no_grad():
        levels, coefs, proto = walk["net"].model[23]((o(16), o(19), o(22)))
    out = walk["out"]
    got = {"proto": (proto, out["proto"])}
    for i in range(3):
        got[f"box {i}"] = (levels[i][0], out["levels"][i][0])
        got[f"cls {i}"] = (levels[i][1], out["levels"][i][1])
        got[f"coef {i}"] = (coefs[i], out["mask_coefs"][i])
    shares = {name: _agreement(g, r)[0] for name, (g, r) in got.items()}
    for name, equal in shares.items():
        bounded(record_property, f"{name} equal_share", equal, ">=",
                LAYER_AGREEMENT[name])
    tree = walk["inter"]["model_23"]
    up = walk["net"].model[23].proto.upsample
    with torch.no_grad():
        got = up(_nchw(_output(tree, "proto_cv1")))
    bounded(record_property, "proto_upsample equal_share",
            _agreement(got, _output(tree, "proto_upsample"))[0], ">=", 0.9999)


@pytest.mark.parametrize("q", [1, 4])
def test_postprocessing_equals_eitx_to_the_bit(walk, q):
    """Decode (the sigmoid and the distribution-focal softmax in XLA's
    order), NMS and the composition (the mask product rounded once, rows
    then columns resized, an antialiased shrink at q = 4) on eitx's raw
    bfloat16 heads: detections and label canvases equal eitx's."""
    conf = ModelConfig().axial_conf_per_class
    hw = (256 // q, 256 // q)
    out = walk["out"]
    det_r, lab_r = jax.jit(lambda o: eitx_post(o, (256, 256), conf, 0.45, 64,
                                               out_hw=hw))(out)
    heads = {"levels": [(_nchw(b), _nchw(c)) for b, c in out["levels"]],
             "strides": (8, 16, 32),
             "mask_coefs": [_nchw(c) for c in out["mask_coefs"]],
             "proto": _nchw(out["proto"])}
    with torch.no_grad():
        det, lab = postprocess_segment_labels(heads, (256, 256), conf, 0.45,
                                              64, out_hw=hw)
    assert np.array_equal(lab.numpy(), np.asarray(lab_r))
    for name in det._fields:
        assert np.array_equal(getattr(det, name).numpy(),
                              np.asarray(getattr(det_r, name))), name


def test_serving_labels_agree_with_eitx(record_property):
    """predict_labels at ModelConfig's serving settings (bfloat16,
    per-class conf, 4 flip views, max_det 64) on the 256 phantom."""
    m = ModelConfig()
    kw = dict(conf=m.axial_conf_per_class, max_det=m.max_detections,
              tta_fill=m.axial_tta_fill, dtype=m.dtype)
    assert m.dtype == "bfloat16"
    img = _phantom_256()
    ref, _ = EitxSegmenter(256, weights=CKPT_256, **kw).predict_labels(img)
    got, _ = TissueSegmenter(256, weights=CKPT_256, device="cpu",
                             **kw).predict_labels(img)
    for c in range(4):
        union = ((ref == c) | (got == c)).sum()
        record_property(f"class {c} IoU",
                        float(((ref == c) & (got == c)).sum() / union))
    record_property("pixels that differ", int((ref != got).sum()))
    bounded(record_property, "agreement", (got == ref).mean(), ">=",
            LABEL_AGREEMENT)
    assert set(np.unique(ref)) == set(np.unique(got))


def _narrow_pair():
    """A narrow random network (widths 4-64) in both packages, bfloat16,
    with random BatchNorm statistics; and its 64x64 input."""
    kw = dict(width=0.0625, depth=0.5, nc=4, proto_stride=4)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.random((2, 64, 64, 3)), jnp.bfloat16)
    fnet = EitxYolo(EitxSpec(**kw))
    variables = fnet.init(jax.random.PRNGKey(5), x.astype(jnp.float32))

    def stat(path, a):
        if path[-1].key == "mean":
            return rng.normal(0, 0.5, a.shape).astype(np.float32)
        return rng.uniform(0.3, 3.0, a.shape).astype(np.float32)

    variables = {
        "params": jax.tree_util.tree_map(np.asarray, variables["params"]),
        "batch_stats": jax.tree_util.tree_map_with_path(
            stat, variables["batch_stats"]),
    }
    tnet = YoloV11(YoloSpec(**kw))
    load_state(tnet, flax_to_torch_state(variables["params"],
                                         variables["batch_stats"]))
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), variables)
    return fnet, variables, tnet.eval().to(BF16), x


def test_narrow_network_batchnorm_and_silu_order(monkeypatch):
    """Layers 0-3 of a narrow random network (convolutions short enough
    to sum in one order) equal eitx's to the bit; torch's own BatchNorm
    and SiLU, which round once, do not."""
    fnet, variables, tnet, x = _narrow_pair()
    _, state = jax.jit(lambda v, x: fnet.apply(
        v, x, train=False, capture_intermediates=True,
        mutable=["intermediates"]))(variables, x)
    ref = [_f32(_output(state["intermediates"], f"model_{i}"))
           for i in range(4)]

    def run():
        y, outs = _nchw(x), []
        with torch.no_grad():
            for i in range(4):
                y = tnet.model[i](y)
                outs.append(_nhwc(y))
        return outs

    for i, got in enumerate(run()):
        assert np.array_equal(got, ref[i]), i
    monkeypatch.setattr(blocks.BatchNorm2d, "_eval_bf16",
                        lambda bn, x: torch.nn.BatchNorm2d.forward(bn, x))
    monkeypatch.setattr(rounding, "silu", torch.nn.functional.silu)
    assert (run()[0] == ref[0]).mean() < 0.9
