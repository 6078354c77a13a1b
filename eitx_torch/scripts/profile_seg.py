"""Per-stage profile of the serving segmentation program.

Port of eitx/scripts/profile_seg.py. The uint8 -> labels program of
``TissueSegmenter`` is split into its stages, each timed alone on
device-resident inputs, with the network's FLOPs counted so that the
convolutions' share against the NMS / compose tail is measured:

  preproc   — cast / scale / channel replicate (``_letterbox``)
  network   — backbone + neck + heads
  decode    — DFL + anchor decode (flat anchors)
  nms       — fixed-budget greedy NMS (``nms_batched``)
  compose   — proto-resolution mask composition to label images

and ``fused_e2e``, the whole program as serving runs it
(``_segment_labels_device``), with each stage's share of it. The network
is also timed on a C=4-padded input sliced back to its 3 channels (eitx's
MXU lane-padding probe, kept as eitx has it).

Times: CUDA events around ``repeats`` calls after a warm-up, the least of
the repeats, on the card; the host's clock on the CPU. FLOPs:
``torch.utils.flop_counter.FlopCounterMode`` over one network call (eitx
reads XLA's ``cost_analysis``); the counter sees the convolutions and
matrix products only.

Usage: python -m eitx_torch.scripts.profile_seg [--imgsz 512] [--batch 128]
           [--repeats 5] [--serving] [--report f.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def _network_flops(network, x) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        network(x)
    return float(counter.get_total_flops())


def profile(imgsz: int = 512, batch: int = 128, repeats: int = 5,
            serving: bool = False, device="cuda") -> dict:
    """The stages' times (ms), the network's GFLOPs and rate, each stage's
    share of the fused program, slices per second of the fused program."""
    from ..core.device import resolve_device
    from ..core.timing import call_ms
    from ..models.yolo.infer import TissueSegmenter, _letterbox
    from ..models.yolo.post import (
        Detections,
        compose_label_image,
        decode_detections,
        nms_batched,
    )

    dev = resolve_device(device)
    B, S = batch, imgsz
    kw = {}
    if serving:
        from ..core.weights import find_checkpoint

        kw["weights"] = find_checkpoint("tissue", S)
    seg = TissueSegmenter(imgsz=S, max_det=64, dtype="bfloat16", device=dev,
                          **kw)
    cdt = seg.compute_dtype
    imgs = np.random.default_rng(0).uniform(0, 255, (B, S, S)).astype(
        np.uint8)
    x_u8 = torch.from_numpy(imgs).to(dev)

    def timed(fn, *a):
        return min(call_ms(fn, *a, repeats=repeats, device=dev))

    with torch.inference_mode():
        def preproc(xu):
            return _letterbox(xu, S, cdt)

        def network(xx):
            return seg.model(xx)

        def decode(o):
            return decode_detections(o)

        def nms_stage(b, s, c, m):
            return nms_batched(b, s, c, m, 0.3, 0.45, 64)

        def compose(proto, d):
            return torch.stack([
                compose_label_image(proto[i], Detections(*(t[i] for t in d)),
                                    (S, S), (S // 4, S // 4))
                for i in range(proto.shape[0])]).to(torch.int8)

        def fused(xu):
            return seg._segment_labels_device(xu, False)

        x = preproc(x_u8)
        out = network(x)
        boxes, scores, classes, coefs = decode(out)
        det = nms_stage(boxes, scores, classes, coefs)
        stages = {
            "preproc": (preproc, (x_u8,)),
            "network": (network, (x,)),
            "decode": (decode, (out,)),
            "nms": (nms_stage, (boxes, scores, classes, coefs)),
            "compose": (compose, (out["proto"], det)),
            "fused_e2e": (fused, (x_u8,)),
        }
        res = {"imgsz": S, "batch": B,
               "graph": "serving" if serving else "random-init bench",
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "timer": "cuda events" if dev.type == "cuda" else "host clock"}
        flops = _network_flops(network, x)
        for name, (fn, a) in stages.items():
            ms = timed(fn, *a)
            f = flops if name == "network" else None
            res[name] = {
                "ms": ms,
                "gflops": f / 1e9 if f else None,
                "tflops_per_s": f / (ms * 1e-3) / 1e12 if f else None,
            }
        fused_ms = res["fused_e2e"]["ms"]
        for name in ("preproc", "network", "decode", "nms", "compose"):
            res[name]["share_of_fused"] = res[name]["ms"] / fused_ms

        # the channel-padding probe: C=3 -> C=4 input, sliced back
        x4 = torch.cat([x, torch.zeros_like(x[:, :1])], 1)
        res["network_c4_slice_ms"] = timed(lambda xx: seg.model(xx[:, :3]),
                                           x4)
    res["slices_per_sec_fused"] = B / (fused_ms / 1e3)
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--imgsz", type=int, default=512)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--serving", action="store_true",
                   help="profile the resolved serving checkpoint instead "
                        "of the fixed random-init bench graph")
    p.add_argument("--report", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    res = profile(args.imgsz, args.batch, args.repeats, args.serving,
                  args.device)
    print(json.dumps(res, indent=1))
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(res, fh, indent=1)
    return res


if __name__ == "__main__":
    main()
