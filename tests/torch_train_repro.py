"""What makes two train steps on the card from the same state differ:
every source of the difference, by op.

    python tests/torch_train_repro.py [--model seg] [--model ribs]
        [--cudnn-deterministic {0,1}] [--costs]

For each network (``seg``: the YOLOv11-n segmenter at chip_smoke.py's
``TRAIN_SEG``, 512², a batch of 8 from a store of 32 phantoms labelled on
the card; ``ribs``: the rib detector at ``TRAIN_RIBS``, 640², a batch of
4) it builds ``Trainer(cfg, seed=0)``, takes the first batch of
``device_batches(store, batch, seed=0)`` and runs the step's forward and
backward twice from the same state (BatchNorm's running statistics put
back between the runs; no optimizer update). Every node of the backward
graph carries a hook: the first run keeps the gradients each node
receives and hands on, the second compares its own with them bit for
bit. A node that receives equal gradients in both runs and hands on
unequal ones is a source of the difference (``"op"``); so is a node
whose received gradient differs although every contribution to it is
equal (``"sum"``: the order of the sum). Every leaf module's forward
output is compared the same way.

Prints one JSON line a network: the forward's agreement, the parameters
whose ``.grad`` differ in backward order with the op that produced each
and the largest absolute and ulp difference, the sources (node, the
module or parameter it belongs to, shapes, largest difference), the
cuDNN settings in force and the card's name and power limit; then one
summary line. ``--cudnn-deterministic`` sets
``torch.backends.cudnn.deterministic`` after ``eitx_torch`` is imported:
0 is the control that shows what the package's setting removes. Exits 1
if a gradient differs under the package's own settings.

``--costs`` times instead each convolution module alone on its input of
the step (forward and backward) with the setting off and then on, and
the serving segmenter's convolutions (``--model serve``: bfloat16,
forward only): one JSON line a network, the totals and the layers whose
time moves most.
"""

import argparse
import collections
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# (config, batch, store) of each network: chip_smoke.py's train phase
NETWORKS = {
    "seg": (cs.TRAIN_SEG, cs.TRAIN_SEG_BATCH, cs.TRAIN_SEG_STORE),
    "ribs": (cs.TRAIN_RIBS, cs.TRAIN_RIBS_BATCH, cs.TRAIN_RIBS_STORE),
}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and a.dtype == b.dtype \
        and torch.equal(_bits(a), _bits(b))


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """float32 bits as integers in the floats' order (adjacent floats are
    adjacent integers)."""
    i = t.detach().contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def _diff(a, b) -> dict:
    """Largest absolute and (float32) ulp difference of a and b."""
    if a is None or b is None or a.shape != b.shape:
        return dict(max_abs=None, max_ulp=None)
    out = dict(max_abs=float((a.double() - b.double()).abs().max()),
               max_ulp=None, elements_differ=int((a != b).sum()))
    if a.dtype == torch.float32:
        ulp = (_ordered(a) - _ordered(b)).abs()
        out.update(max_ulp=int(ulp.max()), elements_differ=int((ulp > 0)
                                                               .sum()))
    return out


def _graph(root):
    """Every node reachable from ``root``, in a fixed order, and the
    contributions to each node's inputs: {(node index, input nr):
    [(parent index, output nr)]}."""
    nodes, index, stack = [], {}, [root]
    while stack:
        n = stack.pop()
        if n is None or id(n) in index:
            continue
        index[id(n)] = len(nodes)
        nodes.append(n)
        stack.extend(c for c, _ in reversed(n.next_functions))
    contrib = collections.defaultdict(list)
    for p, n in enumerate(nodes):
        for k, (c, nr) in enumerate(n.next_functions):
            if c is not None:
                contrib[(index[id(c)], nr)].append((p, k))
    return nodes, index, contrib


def _module_labels(records, index, nodes, param_names):
    """Node index -> the leaf module whose forward made it (walked from
    the module's outputs down to its inputs), or the parameter an
    AccumulateGrad node holds."""
    labels = {}
    for i, n in enumerate(nodes):
        var = getattr(n, "variable", None)
        if var is not None:
            labels[i] = param_names.get(id(var), "leaf")
    for name, ins, outs in records:
        stop = {id(g) for g in ins if g is not None}
        stack = [g for g in outs if g is not None]
        while stack:
            g = stack.pop()
            if id(g) in stop or id(g) not in index:
                continue
            i = index[id(g)]
            if i in labels:
                continue
            labels[i] = name
            stack.extend(c for c, _ in g.next_functions if c is not None)
    return labels


def _leaf_modules(model):
    return [(n, m) for n, m in model.named_modules()
            if not any(True for _ in m.children())]


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def compare_two_steps(trainer, batch) -> dict:
    """The step's forward and backward twice from ``trainer``'s state on
    ``batch``; the differences between the two runs, by node."""
    model = trainer.model
    param_names = {id(p): n for n, p in model.named_parameters()}
    stats = [t.clone() for t in trainer._stats.values()]
    b = trainer._device_batch(batch)
    runs = []
    for _ in range(2):
        torch._foreach_copy_(list(trainer._stats.values()), stats)
        for p in trainer._params:
            p.grad = None
        records, outputs = [], []

        def fwd_hook(name, inputs, out):
            outs = _tensors(out)
            outputs.append((name, [t.detach().clone() for t in outs]))
            records.append((name, [t.grad_fn for t in _tensors(inputs)],
                            [t.grad_fn for t in outs]))

        handles = [m.register_forward_hook(
            lambda mod, i, o, name=n: fwd_hook(name, i, o))
            for n, m in _leaf_modules(model)]
        try:
            loss, _ = trainer._loss(b)
        finally:
            for h in handles:
                h.remove()
        nodes, index, contrib = _graph(loss.grad_fn)
        labels = _module_labels(records, index, nodes, param_names)
        seen, order = {}, []

        def node_hook(i):
            def hook(grad_inputs, grad_outputs):
                order.append(i)
                seen[i] = ([None if g is None else g.detach().clone()
                            for g in grad_outputs],
                           [None if g is None else g.detach().clone()
                            for g in grad_inputs])
            return hook

        hooks = [n.register_hook(node_hook(i)) for i, n in enumerate(nodes)
                 if getattr(n, "variable", None) is None]
        loss.backward()
        for h in hooks:
            h.remove()
        runs.append(dict(
            loss=loss.detach().clone(), outputs=outputs, seen=seen,
            order=order, names=[n.name() for n in nodes], labels=labels,
            contrib=contrib, nodes=nodes,
            grads={n: (None if p.grad is None else p.grad.clone())
                   for n, p in model.named_parameters()},
            stats=[t.clone() for t in trainer._stats.values()]))
    torch._foreach_copy_(list(trainer._stats.values()), stats)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    return _report(*runs, {n: i for i, n in param_names.items()})


def _report(a, b, param_ids) -> dict:
    if a["names"] != b["names"]:
        raise RuntimeError("the two runs built different graphs")
    forward_differs = [na for (na, ta), (_, tb) in zip(a["outputs"],
                                                       b["outputs"])
                       if not all(_equal(x, y) for x, y in zip(ta, tb))]
    stats_equal = all(_equal(x, y) for x, y in zip(a["stats"], b["stats"]))
    # the op under each parameter: the node that hands it its gradient
    producer = {}
    for i, n in enumerate(a["nodes"]):
        for c, _ in n.next_functions:
            var = getattr(c, "variable", None)
            if var is not None:
                producer[id(var)] = i
    rank = {i: k for k, i in enumerate(a["order"])}
    leaves = []
    for name, ga in a["grads"].items():
        gb = b["grads"][name]
        if _equal(ga, gb):
            continue
        i = producer.get(param_ids[name])
        leaves.append(dict(name=name, op=a["names"][i] if i is not None
                           else None, module=a["labels"].get(i),
                           backward_rank=rank.get(i), **_diff(ga, gb)))
    leaves.sort(key=lambda d: (d["backward_rank"] is None,
                               d["backward_rank"]))
    sources = []
    for i in a["order"]:
        ins_a, outs_a = a["seen"][i]
        ins_b, outs_b = b["seen"][i]
        in_equal = [_equal(x, y) for x, y in zip(ins_a, ins_b)]
        out_equal = [_equal(x, y) for x, y in zip(outs_a, outs_b)]
        where = dict(node=a["names"][i], module=a["labels"].get(i, "loss"),
                     backward_rank=rank[i],
                     shapes=[None if g is None else list(g.shape)
                             for g in outs_a])
        if all(in_equal) and not all(out_equal):
            k = out_equal.index(False)
            sources.append(dict(kind="op", output=k, **where,
                                **_diff(outs_a[k], outs_b[k])))
        for nr, eq in enumerate(in_equal):
            parts = a["contrib"].get((i, nr), [])
            if eq or len(parts) < 2:
                continue
            if all(_equal(a["seen"][p][1][k], b["seen"][p][1][k])
                   for p, k in parts if p in a["seen"] and p in b["seen"]):
                sources.append(dict(kind="sum", input=nr,
                                    contributions=len(parts), **where,
                                    **_diff(ins_a[nr], ins_b[nr])))
    return dict(loss_equal=_equal(a["loss"], b["loss"]),
                forward_equal=not forward_differs and stats_equal,
                forward_differs=forward_differs[:8],
                running_stats_equal=stats_equal,
                nodes=len(a["names"]), leaves=len(a["grads"]),
                leaves_differ=leaves, sources=sources,
                source_ops=dict(collections.Counter(
                    s["node"] for s in sources)))


def _store(name: str, cfg: dict, n: int, dev):
    """The train phase's store of ``n`` phantoms (the segmenter's labelled
    on ``dev``) or rib images."""
    from eitx_torch.train.phantoms import phantom_batch, rib_batch

    rng = np.random.default_rng(0)
    if name == "ribs":
        return rib_batch(n, cfg["imgsz"], cfg["max_instances"], rng)
    return phantom_batch(n, cfg["imgsz"], cfg["max_instances"], rng,
                         mask_res=cs.TRAIN_MASK_RES, store_u8=True,
                         device=dev)


def measure(name: str, dev) -> dict:
    """One network's two runs, at the train phase's configuration."""
    from eitx_torch.train import TrainConfig, Trainer
    from eitx_torch.train.data import device_batches

    cfg, batch, store = NETWORKS[name]
    trainer = Trainer(TrainConfig(**cfg), seed=0, device=dev)
    stream = device_batches(_store(name, cfg, store, dev), batch, seed=0,
                            device=dev)
    out = compare_two_steps(trainer, next(stream))
    return dict(network=name, config=cfg, batch=batch, cudnn=dict(
        deterministic=torch.backends.cudnn.deterministic,
        benchmark=torch.backends.cudnn.benchmark,
        allow_tf32=torch.backends.cudnn.allow_tf32),
        deterministic_algorithms=torch.are_deterministic_algorithms_enabled(),
        device=str(dev), card=cs.gpu_name_and_limit()
        if dev.type == "cuda" else "cpu", **out)


def _cuda_ms(fn, reps: int = 10) -> float:
    """ms of one ``fn()``, ``reps`` back to back between two CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def conv_costs(model, run, backward: bool) -> dict:
    """Each convolution module's input in one ``run()`` (the first call of
    each), then its forward and (with ``backward``) its backward alone on
    that input, timed with ``torch.backends.cudnn.deterministic`` off and
    on: which layers the setting makes slower, and by how much."""
    from torch import nn

    calls = {}

    def keep(name, m, x):
        if name not in calls:
            calls[name] = (m, x.detach().clone())

    hooks = [m.register_forward_hook(lambda m, i, o, n=n: keep(n, m, i[0]))
             for n, m in model.named_modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    first = next(iter(calls))  # the image's convolution: no input gradient
    saved = torch.backends.cudnn.deterministic
    rows = []
    try:
        for name, (m, x) in calls.items():
            row = dict(name=name, kind=type(m).__name__, groups=m.groups,
                       kernel=list(m.kernel_size), input=list(x.shape))
            for det in (False, True):
                torch.backends.cudnn.deterministic = det
                key = "det" if det else "nondet"
                if not backward:
                    with torch.no_grad():
                        row[f"fwd_{key}"] = _cuda_ms(lambda: m(x))
                    continue
                xi = x.detach().requires_grad_(name != first)
                row[f"fwd_{key}"] = _cuda_ms(lambda: m(xi))
                y = m(xi)
                g = torch.full_like(y, 1e-3)
                wrt = ([xi] if name != first else []) + list(m.parameters())
                row[f"bwd_{key}"] = _cuda_ms(lambda: torch.autograd.grad(
                    y, wrt, g, retain_graph=True))
            row["delta_ms"] = sum(row[k] for k in row if k.endswith("_det")) \
                - sum(row[k] for k in row if k.endswith("_nondet"))
            rows.append(row)
    finally:
        torch.backends.cudnn.deterministic = saved
    keys = [k for k in rows[0] if k.startswith(("fwd_", "bwd_"))]
    return dict(convolutions=len(rows),
                total_ms={k: sum(r[k] for r in rows) for k in keys},
                delta_ms=sum(r["delta_ms"] for r in rows),
                largest=sorted(rows, key=lambda r: -abs(r["delta_ms"]))[:8])


def measure_costs(name: str, dev) -> dict:
    """``conv_costs`` of a network of the train phase (forward and
    backward at its batch) or, for ``serve``, of the serving segmenter
    (``tissue_n_512``, bfloat16, forward only) labelling the 512² slice
    of ``tests/data/torch_smoke_512.npz``."""
    if name == "serve":
        from eitx_torch.core.config import ModelConfig
        from eitx_torch.models.yolo.infer import TissueSegmenter

        m = ModelConfig()
        seg = TissueSegmenter(
            512, weights=os.path.join(ROOT, "weights", "tissue_n_512.msgpack"),
            conf=m.axial_conf_per_class, max_det=m.max_detections,
            tta_fill=m.axial_tta_fill, dtype=m.dtype, device=dev)
        image = np.load(os.path.join(ROOT, "tests", "data",
                                     "torch_smoke_512.npz"))["image"]
        out = conv_costs(seg.model, lambda: seg.predict_labels(image), False)
        return dict(network=name, dtype=m.dtype, card=cs.gpu_name_and_limit(),
                    **out)
    from eitx_torch.train import TrainConfig, Trainer
    from eitx_torch.train.data import device_batches

    cfg, batch, store = NETWORKS[name]
    trainer = Trainer(TrainConfig(**cfg), seed=0, device=dev)
    b = trainer._device_batch(next(device_batches(
        _store(name, cfg, store, dev), batch, seed=0, device=dev)))
    out = conv_costs(trainer.model, lambda: trainer._loss(b), True)
    return dict(network=name, batch=batch, card=cs.gpu_name_and_limit(),
                **out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", action="append",
                    choices=sorted(NETWORKS) + ["serve"], default=None)
    ap.add_argument("--cudnn-deterministic", type=int, choices=(0, 1),
                    default=None, help="override the package's setting")
    ap.add_argument("--costs", action="store_true",
                    help="time each convolution with the setting off and "
                    "on (seg, ribs and the serving segmenter) instead")
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import eitx_torch  # noqa: F401  (its settings)

    if args.costs:
        for name in args.model or ["seg", "ribs", "serve"]:
            print(json.dumps(measure_costs(name, torch.device(args.device))),
                  flush=True)
        return 0

    if args.cudnn_deterministic is not None:
        torch.backends.cudnn.deterministic = bool(args.cudnn_deterministic)
    dev = torch.device(args.device)
    differ = {}
    for name in args.model or ["seg", "ribs"]:
        r = measure(name, dev)
        print(json.dumps(r), flush=True)
        differ[name] = len(r["leaves_differ"])
    print(json.dumps({"leaves_differ": differ, "cudnn_deterministic":
                      torch.backends.cudnn.deterministic}), flush=True)
    own = args.cudnn_deterministic is None
    return 1 if own and any(differ.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
