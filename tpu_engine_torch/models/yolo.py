"""YOLOv8-family detection models, the mixed-shape serving workload
(counterpart of ``tpu_engine/models/yolo.py``; same names, config,
parameter tree and forward).

The reference's YOLOv8n deployment (BASELINE.json config 4) serves images
of several sizes; the model is fully convolutional, so one set of weights
serves every resolution divisible by 32, and the engine's shape buckets
(``runtime.engine``) pick each request's canvas. Architecture: a
Conv(+BN+SiLU) stem, C2f stages (split, n bottlenecks, concat), SPPF, an
FPN+PAN neck over P3/P4/P5 and a decoupled head per level. Output per
sample: (n_anchors, 4 * reg_max + num_classes) raw head maps, P3 rows
first, n_anchors = H/8 * W/8 + H/16 * W/16 + H/32 * W/32.

Inputs arrive as the JAX package's (B, H, W, 3) NHWC tensors and outputs
leave as (B, n_anchors, head_ch), as in JAX; inside, the forward runs
NCHW in channels_last memory over OIHW kernels (``models.resnet``'s
layout). Each conv rounds its operands to the compute dtype and sums in
f32 (``ops.nn.conv2d``, XLA's "SAME" padding); batch norm, SiLU, the
pools and the residual adds run in f32 on its result, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from tpu_engine_torch.models.registry import ModelSpec, register
from tpu_engine_torch.models.resnet import _Init, _nchw
from tpu_engine_torch.ops import nn


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    num_classes: int = 80
    reg_max: int = 16
    # Per-stage output channels (v8n = width 0.25 of [64,128,256,512,1024]).
    widths: Tuple[int, ...] = (16, 32, 64, 128, 256)
    # C2f bottleneck counts per stage (v8n = depth 1/3 of [3,6,6,3]).
    depths: Tuple[int, ...] = (1, 2, 2, 1)

    @property
    def head_ch(self) -> int:
        return 4 * self.reg_max + self.num_classes


# -- blocks -------------------------------------------------------------------

def _conv_init(ini: _Init, k: int, cin: int, cout: int):
    return {"conv": ini.conv(k, cin, cout), "bn": ini.bn(cout)}


def _conv(p, x, stride=1, dtype=None):
    x = nn.conv2d(p["conv"], x, stride=stride, dtype=dtype)
    return nn.silu(nn.batchnorm(p["bn"], x))


def _bottleneck_init(ini: _Init, c: int):
    return {"cv1": _conv_init(ini, 3, c, c), "cv2": _conv_init(ini, 3, c, c)}


def _bottleneck(p, x, dtype=None):
    return x + _conv(p["cv2"], _conv(p["cv1"], x, dtype=dtype), dtype=dtype)


def _c2f_init(ini: _Init, cin: int, cout: int, n: int):
    c = cout // 2
    return {"cv1": _conv_init(ini, 1, cin, cout),
            "cv2": _conv_init(ini, 1, (2 + n) * c, cout),
            "m": [_bottleneck_init(ini, c) for _ in range(n)]}


def _c2f(p, x, dtype=None):
    y = _conv(p["cv1"], x, dtype=dtype)
    outs = list(torch.chunk(y, 2, dim=1))
    for bp in p["m"]:
        outs.append(_bottleneck(bp, outs[-1], dtype=dtype))
    return _conv(p["cv2"], torch.cat(outs, dim=1), dtype=dtype)


def _sppf_init(ini: _Init, c: int):
    h = c // 2
    return {"cv1": _conv_init(ini, 1, c, h), "cv2": _conv_init(ini, 1, 4 * h, c)}


def _sppf(p, x, dtype=None):
    y = _conv(p["cv1"], x, dtype=dtype)
    p1 = nn.max_pool(y, 5, 1)
    p2 = nn.max_pool(p1, 5, 1)
    p3 = nn.max_pool(p2, 5, 1)
    return _conv(p["cv2"], torch.cat([y, p1, p2, p3], dim=1), dtype=dtype)


def _upsample2x(x):
    """Nearest-neighbour 2x over H and W."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _head_branch_init(ini: _Init, cin: int, mid: int, cout: int):
    return {"cv1": _conv_init(ini, 3, cin, mid),
            "cv2": _conv_init(ini, 3, mid, mid),
            "out": ini.conv(1, mid, cout)}


def _head_branch(p, x, dtype=None):
    x = _conv(p["cv2"], _conv(p["cv1"], x, dtype=dtype), dtype=dtype)
    return nn.conv2d(p["out"], x, dtype=dtype)


# -- model --------------------------------------------------------------------

def yolo_init(seed: int, cfg: YoloConfig, device=None, dtype="bfloat16"):
    """Seeded random parameters (the JAX tree; He-normal conv kernels OIHW
    in the compute dtype, identity batch norm; the numbers are not
    JAX's)."""
    ini = _Init(seed, device, dtype)
    w, d = cfg.widths, cfg.depths
    params = {
        "stem": _conv_init(ini, 3, 3, w[0]),                 # /2  (P1)
        "down1": _conv_init(ini, 3, w[0], w[1]),             # /4  (P2)
        "c2f1": _c2f_init(ini, w[1], w[1], d[0]),
        "down2": _conv_init(ini, 3, w[1], w[2]),             # /8  (P3)
        "c2f2": _c2f_init(ini, w[2], w[2], d[1]),
        "down3": _conv_init(ini, 3, w[2], w[3]),             # /16 (P4)
        "c2f3": _c2f_init(ini, w[3], w[3], d[2]),
        "down4": _conv_init(ini, 3, w[3], w[4]),             # /32 (P5)
        "c2f4": _c2f_init(ini, w[4], w[4], d[3]),
        "sppf": _sppf_init(ini, w[4]),
        "fpn4": _c2f_init(ini, w[4] + w[3], w[3], d[3]),     # FPN top-down
        "fpn3": _c2f_init(ini, w[3] + w[2], w[2], d[3]),
        "pan_d3": _conv_init(ini, 3, w[2], w[2]),             # PAN bottom-up
        "pan4": _c2f_init(ini, w[2] + w[3], w[3], d[3]),
        "pan_d4": _conv_init(ini, 3, w[3], w[3]),
        "pan5": _c2f_init(ini, w[3] + w[4], w[4], d[3]),
    }
    mid = max(w[2], cfg.head_ch // 4)
    params["head"] = [_head_branch_init(ini, c, mid, cfg.head_ch)
                      for c in (w[2], w[3], w[4])]
    return params


def yolo_apply(params, x, cfg: YoloConfig, dtype=torch.bfloat16):
    """x: (B, H, W, 3) with H, W divisible by 32 -> (B, n_anchors,
    head_ch) f32: the raw multi-scale head maps, anchor-major (P3 rows,
    then P4, then P5)."""
    x = _nchw(x.to(dtype))
    x = _conv(params["stem"], x, stride=2, dtype=dtype)
    x = _conv(params["down1"], x, stride=2, dtype=dtype)
    x = _c2f(params["c2f1"], x, dtype=dtype)
    x = _conv(params["down2"], x, stride=2, dtype=dtype)
    p3 = _c2f(params["c2f2"], x, dtype=dtype)
    x = _conv(params["down3"], p3, stride=2, dtype=dtype)
    p4 = _c2f(params["c2f3"], x, dtype=dtype)
    x = _conv(params["down4"], p4, stride=2, dtype=dtype)
    p5 = _sppf(params["sppf"], _c2f(params["c2f4"], x, dtype=dtype),
               dtype=dtype)

    f4 = _c2f(params["fpn4"], torch.cat([_upsample2x(p5), p4], dim=1),
              dtype=dtype)
    f3 = _c2f(params["fpn3"], torch.cat([_upsample2x(f4), p3], dim=1),
              dtype=dtype)
    n4 = _c2f(params["pan4"], torch.cat(
        [_conv(params["pan_d3"], f3, stride=2, dtype=dtype), f4], dim=1),
        dtype=dtype)
    n5 = _c2f(params["pan5"], torch.cat(
        [_conv(params["pan_d4"], n4, stride=2, dtype=dtype), p5], dim=1),
        dtype=dtype)

    outs = []
    for p, feat in zip(params["head"], (f3, n4, n5)):
        y = _head_branch(p, feat, dtype=dtype)  # (B, head_ch, h, w)
        b, c = y.shape[:2]
        outs.append(y.permute(0, 2, 3, 1).reshape(b, -1, c))
    return torch.cat(outs, dim=1).float()


def n_anchors(h: int, w: int) -> int:
    return (h // 8) * (w // 8) + (h // 16) * (w // 16) + (h // 32) * (w // 32)


def _make_spec(name: str, cfg: YoloConfig, size: int) -> ModelSpec:
    def init(seed, device, dtype):
        return yolo_init(seed, cfg, device=device, dtype=dtype)

    def apply(params, x, dtype=torch.bfloat16):
        return yolo_apply(params, x, cfg, dtype=dtype)

    return ModelSpec(name, cfg, apply=apply, init_fn=init,
                     input_shape=(size, size, 3),
                     output_shape=(n_anchors(size, size), cfg.head_ch))


@register("yolov8n")
def make_yolov8n(size: int = 640, num_classes: int = 80) -> ModelSpec:
    return _make_spec("yolov8n", YoloConfig(num_classes=num_classes), size)


@register("yolov8n-small-test")
def make_yolo_small(size: int = 64, num_classes: int = 4) -> ModelSpec:
    """Tiny config for tests: the same code path."""
    cfg = YoloConfig(num_classes=num_classes, reg_max=4,
                     widths=(8, 8, 16, 16, 32), depths=(1, 1, 1, 1))
    return _make_spec("yolov8n-small-test", cfg, size)
