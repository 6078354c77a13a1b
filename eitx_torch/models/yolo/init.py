"""flax's initial parameters for the port's YOLOv11, from a seed.

eitx builds an untrained network as ``YoloV11(spec).init(PRNGKey(seed),
x)`` (eitx/train/trainer.py:172-176, eitx/models/yolo/infer.py:132-135).
This module computes the same numbers without JAX or flax:

  - The tree. Paths and shapes are the torch model's, through
    ``checkpoint.torch_to_flax_tree`` (kernels in flax's layout: a
    convolution's (kh, kw, in / groups, out), a ``ConvTranspose`` with
    ``transpose_kernel`` (kh, kw, out, in)).
  - The keys. flax draws each parameter from the root key folded with the
    first four bytes (big-endian) of the SHA-1 of its module's path and a
    counter (``flax/core/scope.py`` ``_fold_in_static``, with
    ``flax_fix_rng_separator`` off: the names hashed back to back, the
    counter as its shortest big-endian bytes). The counter is the module's
    ``make_rng("params")`` count; a kernel is each module's first
    parameter, so its counter is 1.
  - The initialisers, those of eitx's modules (eitx/models/yolo/blocks.py:
    38-55, model.py:87-125): ``nn.Conv`` and ``nn.ConvTranspose`` kernels
    lecun-normal (variance 1 / fan_in on flax's layout, a normal truncated
    at 2 standard deviations: ``jax.nn.initializers.variance_scaling``),
    biases zero; ``nn.BatchNorm`` scale one, bias zero, mean zero, variance
    one. Those constants take no draw.

The draws are ``core.prng``'s, on the host, so the parameters are the same
bits on every device; they equal eitx's on every element
(``tests/test_torch_train.py``, ``test_torch_yolo.py``,
``test_torch_prng.py``). The tree's shapes come from a network built on
the ``meta`` device, which allocates and draws nothing. A process keeps
the last few networks' host arrays (``_flax_init_trees``): building a
second runner or trainer of the same spec and seed copies them instead of
drawing again. Neither function touches torch's global random state.
"""

from __future__ import annotations

import functools
import hashlib
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ...core import prng
from .checkpoint import flax_to_torch_state, load_state, torch_to_flax_tree
from .model import YoloSpec, YoloV11

_TRUNC_STD = np.float32(0.87962566103423978)  # std of N(0, 1) cut at +-2


def param_key(root: np.ndarray, path: Tuple[str, ...],
              counter: int) -> np.ndarray:
    """flax's key for the ``counter``-th parameter of the module at ``path``
    under the root key ``root``."""
    h = hashlib.sha1()
    for name in path:
        h.update(name.encode("utf-8"))
    h.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return prng.fold_in(root, int.from_bytes(h.digest()[:4], "big"))


def lecun_normal(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """``flax.linen.initializers.lecun_normal()`` for a kernel of flax shape
    ``shape`` (fan in: the receptive field times ``shape[-2]``), float32."""
    receptive = math.prod(shape) / shape[-2] / shape[-1]
    variance = np.float32(1.0 / (shape[-2] * receptive))
    stddev = np.sqrt(variance) / _TRUNC_STD
    return prng.truncated_normal(key, -2, 2, shape) * stddev


@functools.lru_cache(maxsize=4)
def _flax_init_trees(spec: YoloSpec, seed: int) -> Tuple[Dict, Dict]:
    with torch.device("meta"):
        shapes = YoloV11(spec).state_dict()
    params, stats = torch_to_flax_tree(
        {n: np.empty(t.shape, np.float32) for n, t in shapes.items()})
    root = prng.key(seed)

    def fill(tree: Dict, path: Tuple[str, ...]) -> None:
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                fill(leaf, path + (name,))
            elif name == "kernel":
                tree[name] = lecun_normal(param_key(root, path, 1),
                                          leaf.shape)
            else:  # BatchNorm's scale and variance one, the rest zero
                tree[name] = np.full(leaf.shape, name in ("scale", "var"),
                                     np.float32)

    fill(params, ())
    fill(stats, ())
    return params, stats


def flax_init_state(spec: YoloSpec, seed: int) -> Dict[str, torch.Tensor]:
    """The state dict (CPU tensors, float32) of eitx's ``YoloV11(spec)
    .init(PRNGKey(seed), ...)``."""
    return flax_to_torch_state(*_flax_init_trees(spec, int(seed)))


def flax_init_model(spec: YoloSpec, seed: int) -> YoloV11:
    """A ``YoloV11(spec)`` on the CPU holding ``flax_init_state(spec,
    seed)``; torch's global random state is left as it was (the network's
    own initialisation, overwritten here, would draw from it)."""
    with torch.random.fork_rng(devices=[]):
        model = YoloV11(spec)
    load_state(model, flax_init_state(spec, seed))
    return model
