"""The port's threefry draws (eitx_torch/core/prng.py) against jax.random,
and flax's initial parameters (eitx_torch/models/yolo/init.py) against
flax's, on the CPU.

Tolerance: none. Integer draws, ``uniform`` and ``truncated_normal`` equal
JAX's on every bit; the float32 helpers that ``truncated_normal`` is made of
(``erf``, ``log1p``, ``erf_inv`` as XLA:CPU compiles them, the fused
multiply-add) equal XLA's, or the exact rational result, on every bit. The
reference is pinned: JAX 0.9.0 with ``jax_threefry_partitionable`` on,
flax 0.12.3 with ``flax_fix_rng_separator`` off. Another version fails
here first instead of drifting."""

from fractions import Fraction

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import flax
import jax
import jax.numpy as jnp
from jax import lax

from eitx_torch.core import prng
from eitx_torch.models.yolo import init as port_init

SEEDS = st.integers(0, 2 ** 31 - 1)


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


def _key_data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k))


def test_reference_versions_and_settings():
    """The semantics the port reproduces are these versions' and flags'."""
    assert jax.__version__ == "0.9.0"
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_enable_x64 is False
    assert flax.__version__ == "0.12.3"
    assert flax.config.flax_fix_rng_separator is False


@settings(max_examples=20, deadline=None)
@given(seed=SEEDS)
def test_key_split_fold_in(seed):
    k, want = prng.key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(k, _key_data(want))
    for n in (2, 3, 6):
        np.testing.assert_array_equal(prng.split(k, n),
                                      _key_data(jax.random.split(want, n)))
    for d in (0, 1, seed, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(k, d),
            _key_data(jax.random.fold_in(want, np.uint32(d))))


def test_key_of_negative_and_wide_seeds():
    """JAX takes a seed through int64 to its low 32 bits (x64 off)."""
    for seed in (-1, -5, 2 ** 31 + 5, 2 ** 40 + 3, 2 ** 63 - 1):
        np.testing.assert_array_equal(
            prng.key(seed), _key_data(jax.random.PRNGKey(seed)))


def test_split_of_a_stack_of_keys():
    """A stack of keys splits as each key alone (the batched form the
    stream and the initialiser use)."""
    keys = prng.split(prng.key(3), 5)
    got = prng.split(keys, 6)
    for i in range(5):
        np.testing.assert_array_equal(got[i], prng.split(keys[i], 6))


@settings(max_examples=15, deadline=None)
@given(seed=SEEDS)
def test_random_bits_and_uniform(seed):
    k, want = prng.key(seed), jax.random.PRNGKey(seed)
    for shape in ((0,), (7,), (3, 5), (), (2, 3, 4)):
        np.testing.assert_array_equal(prng.random_bits(k, shape),
                                      np.asarray(jax.random.bits(want, shape)))
        np.testing.assert_array_equal(
            _bits(prng.uniform(k, shape)),
            _bits(jax.random.uniform(want, shape)))
    np.testing.assert_array_equal(
        _bits(prng.uniform(k, (64,), -3.0, 0.5)),
        _bits(jax.random.uniform(want, (64,), minval=-3.0, maxval=0.5)))


@settings(max_examples=15, deadline=None)
@given(seed=SEEDS)
def test_randint(seed):
    """Spans small, odd, past 2^16 (the multiplier's square wraps uint32)
    and the widest; an empty range draws its lower bound."""
    k, want = prng.key(seed), jax.random.PRNGKey(seed)
    for lo, hi in ((0, 1), (0, 37), (0, 2 ** 16 + 1), (0, 2 ** 31 - 1),
                   (-100, 17), (-2 ** 31, 2 ** 31 - 1), (5, 5), (9, 2)):
        np.testing.assert_array_equal(
            prng.randint(k, (9, 4), lo, hi),
            np.asarray(jax.random.randint(want, (9, 4), lo, hi)))


@settings(max_examples=10, deadline=None)
@given(seed=SEEDS)
def test_truncated_normal(seed):
    """Shapes below and above one chunk of the port's loop."""
    k, want = prng.key(seed), jax.random.PRNGKey(seed)
    for shape in ((3, 3, 16, 32), (1, 1, 7, 5), (3, 3, 64, 128)):
        np.testing.assert_array_equal(
            _bits(prng.truncated_normal(k, -2, 2, shape)),
            _bits(jax.random.truncated_normal(want, -2, 2, shape,
                                              jnp.float32)))


def test_truncated_normal_of_a_stack_of_keys():
    keys = prng.split(prng.key(11), 3)
    got = prng.truncated_normal(keys, -2, 2, (40,))
    for i in range(3):
        np.testing.assert_array_equal(
            _bits(got[i]), _bits(prng.truncated_normal(keys[i], -2, 2, (40,))))


@pytest.mark.parametrize("name,lo,hi", [
    ("erf", -5.0, 5.0), ("log1p", -1.0, 0.0), ("log1p", -0.9, 40.0),
    ("erf_inv", -1.0, 1.0)])
def test_float32_functions_equal_xla_cpu(name, lo, hi):
    """XLA:CPU's float32 functions, compiled, on 2e5 inputs (both branches
    of log1p and of erf_inv, the clamp of erf, erf_inv at +-1)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(lo, hi, 200_000).astype(np.float32)
    if name == "log1p" and hi == 0.0:
        x = x * -x  # erf_inv's argument
    if name == "erf_inv":
        x[:2] = [-1.0, 1.0]
    want = jax.jit(getattr(lax, name))(x)
    got = getattr(prng, f"{name}_f32")(x)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _exact_fma(a, b, c) -> np.float32:
    """a * b + c rounded once to float32, from exact rationals."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    lo = np.float32(float(v))  # a float32 neighbour of v
    cands = [lo, np.nextafter(lo, np.float32(np.inf)),
             np.nextafter(lo, np.float32(-np.inf))]
    dist = [abs(Fraction(float(x)) - v) for x in cands]
    best = min(dist)
    ties = [x for x, d in zip(cands, dist) if d == best]
    if len(ties) > 1:  # round half to even
        return [x for x in ties if not (np.asarray(x).view(np.uint32) & 1)][0]
    return ties[0]


def test_fma_f32_rounds_once():
    """Random operands, and sums built to land half-way between two float32
    numbers, where rounding in float64 first would round twice."""
    rng = np.random.default_rng(1)
    a = rng.uniform(-4, 4, 400).astype(np.float32)
    b = rng.uniform(-4, 4, 400).astype(np.float32)
    c = rng.uniform(-4, 4, 400).astype(np.float32)
    # c = -(a * b) rounded to float32 plus half an ulp of the product's
    # float32: the exact sum sits on or next to a float32 midpoint
    p = (a.astype(np.float64) * b).astype(np.float32)
    half = (np.spacing(np.abs(p)) / 2).astype(np.float32)
    c2 = (-p + half).astype(np.float32)
    a3 = np.float32(1 + 2 ** -23) * np.ones(50, np.float32)
    b3 = np.float32(1 + 2 ** -23) + np.arange(50, dtype=np.float32) * 2 ** -22
    c3 = np.full(50, np.float32(-1.0))
    for x, y, z in ((a, b, c), (a, b, c2), (a3, b3.astype(np.float32), c3)):
        got = prng.fma_f32(x, y, z)
        want = np.array([_exact_fma(*t) for t in zip(x, y, z)], np.float32)
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_fma_f32_double_rounding_case():
    """A sum that float64 rounds onto a float32 midpoint from below:
    a * b = 2^-24 - 2^-64 exactly, c = 1 + 2^-23, so a * b + c = 1 + 3 *
    2^-24 - 2^-64. Rounding through float64 lands on the midpoint and then
    on the even neighbour 1 + 2^-22; the fused operation rounds down to
    1 + 2^-23."""
    a = np.float32(2 ** -12 * (1 - 2 ** -20))
    b = np.float32(2 ** -12 * (1 + 2 ** -20))
    c = np.float32(1 + 2 ** -23)
    twice = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    assert twice == np.float32(1 + 2 ** -22)
    got = prng.fma_f32(a, b, c)
    assert got == _exact_fma(a, b, c) == np.float32(1 + 2 ** -23)


@pytest.mark.parametrize("path,counter", [
    (("model_0", "conv"), 1), (("model_23", "proto_upsample"), 2),
    ((), 1), (("m",), 300)])
def test_param_key_is_flax_fold_in_static(path, counter):
    from flax.core.scope import _fold_in_static

    root = jax.random.PRNGKey(7)
    want = _fold_in_static(root, path + (counter,))
    np.testing.assert_array_equal(
        port_init.param_key(prng.key(7), path, counter), _key_data(want))


@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (1, 1, 64, 4),
                                   (2, 2, 48, 64), (3, 3, 1, 128)])
def test_lecun_normal_equals_flax(shape):
    """Conv kernels (fan in from the receptive field and in-channels) and a
    transposed kernel's layout (kh, kw, out, in)."""
    key = jax.random.PRNGKey(4)
    want = flax.linen.initializers.lecun_normal()(key, shape, jnp.float32)
    got = port_init.lecun_normal(prng.key(4), shape)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_port_reproduces_the_card_fixture():
    """What chip_smoke.py's train phase holds the card to, on the CPU:
    tests/data/torch_prng_fixture.npz (eitx's YOLOv11-n trainer and
    untrained YOLOv11-s segmenter of seed 0, eitx's first batches of a
    seeded stream) equals the port's on every element and every byte."""
    import torch_prng_check as check
    from eitx_torch.models.yolo.infer import TissueSegmenter
    from eitx_torch.train import TrainConfig, Trainer

    fx = check.load_fixture()
    cfg = dict(fx["meta"]["trainer_n"])
    seed = cfg.pop("seed")
    tr = Trainer(TrainConfig(**cfg), seed=seed, device="cpu")
    seg = TissueSegmenter(device="cpu", **fx["meta"]["segmenter_s"])
    for net, state in (("trainer_n", {**tr.state.params,
                                      **tr.state.batch_stats}),
                       ("segmenter_s", seg.model.state_dict())):
        assert check.leaf_errors(fx, net, state) == {
            "leaves": 470, "names_equal": True, "leaves_differ": [],
            "sums_equal": True, "max_ulp": 0}, net
    it = check.stream(fx, "cpu")
    batches = [next(it) for _ in range(fx["meta"]["stream"]["steps"])]
    assert check.stream_errors(fx, batches) == {
        "steps": 3, "draws_differ": [], "batches_differ": []}


def test_initial_network_leaves_torch_rng_alone():
    """``flax_init_model`` holds ``flax_init_state``'s parameters and leaves
    torch's global random state as it found it: neither its shape template
    (built on the ``meta`` device) nor the network it overwrites draws from
    it."""
    import torch

    from eitx_torch.models.yolo.model import yolov11_spec

    spec = yolov11_spec("n", nc=1, segment=False)
    torch.manual_seed(5)
    before = torch.get_rng_state()
    model = port_init.flax_init_model(spec, 3)
    assert torch.equal(torch.get_rng_state(), before)
    state = model.state_dict()
    for name, t in port_init.flax_init_state(spec, 3).items():
        assert torch.equal(state[name], t), name
