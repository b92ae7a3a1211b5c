"""ResNet-50 v2 (pre-activation) and v1.5 (post-activation), the one-shot
/infer models (counterpart of ``tpu_engine/models/resnet.py``; same names,
widths, depths and parameter tree, conv kernels OIHW).

Inputs arrive as the JAX package's (B, H, W, 3) NHWC tensors; the forward
runs them as NCHW in channels_last memory (``permute``, no copy), with
kernels stored channels_last too, so no convolution transposes anything.
Each conv casts its input to the compute dtype and returns f32; batch
norm, ReLU, the pools and the residual stream stay in f32, as in JAX.

Padding follows the JAX functions: v2 uses XLA's "SAME", which at stride 2
is asymmetric (``nn.same_pads``: the stem at 224 pads (2, 3), each stage's
first 3x3/2 (0, 1), the 3x3/2 max pool (0, 1) with -inf); v1.5 passes
explicit symmetric padding (k // 2 per side) and keeps it.
"""

from __future__ import annotations

import torch

from tpu_engine_torch.models.mlp import dense_init
from tpu_engine_torch.models.registry import ModelSpec, register
from tpu_engine_torch.ops import nn

_STAGES = (3, 4, 6, 3)
_WIDTHS = (64, 128, 256, 512)
_EXPANSION = 4
_NO_PAD = ((0, 0), (0, 0))
_PAD1 = ((1, 1), (1, 1))


class _Init:
    """Seeded random parameters on one device: He-normal conv kernels
    (OIHW, channels_last, in the compute dtype) and identity batch norm
    (f32), ``nn.conv_init``'s and ``nn.batchnorm_init``'s distributions
    (the numbers are not JAX's)."""

    def __init__(self, seed, device, dtype):
        from tpu_engine_torch.utils.device import resolve_device, resolve_dtype

        self.dev, self.dt = resolve_device(device), resolve_dtype(dtype)
        self.g = torch.Generator(device=self.dev)
        self.g.manual_seed(int(seed))

    def conv(self, k: int, c_in: int, c_out: int):
        w = torch.randn((c_out, c_in, k, k), generator=self.g,
                        device=self.dev) * (2.0 / (k * k * c_in)) ** 0.5
        return {"kernel": w.to(self.dt).contiguous(
            memory_format=torch.channels_last)}

    def bn(self, ch: int):
        ones = torch.ones((ch,), device=self.dev)
        zeros = torch.zeros((ch,), device=self.dev)
        return {"scale": ones, "bias": zeros, "mean": zeros.clone(),
                "var": ones.clone()}

    def dense(self, n_in: int, n_out: int):
        return dense_init(self.g, n_in, n_out, self.dev, self.dt)


def _strides():
    """(stage, block, stride) of the 16 bottleneck blocks."""
    for s, n_blocks in enumerate(_STAGES):
        for b in range(n_blocks):
            yield s, b, (2 if (b == 0 and s > 0) else 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W) in channels_last memory (a view when x
    is contiguous)."""
    return x.permute(0, 3, 1, 2)


# -- v2 (pre-activation) ------------------------------------------------------

def _block_init(init: _Init, in_ch: int, mid_ch: int, stride: int):
    out_ch = mid_ch * _EXPANSION
    params = {"bn1": init.bn(in_ch), "conv1": init.conv(1, in_ch, mid_ch),
              "bn2": init.bn(mid_ch), "conv2": init.conv(3, mid_ch, mid_ch),
              "bn3": init.bn(mid_ch), "conv3": init.conv(1, mid_ch, out_ch)}
    if stride != 1 or in_ch != out_ch:
        params["proj"] = init.conv(1, in_ch, out_ch)
    return params


def _block_apply(params, x, stride: int, dtype):
    pre = nn.relu(nn.batchnorm(params["bn1"], x))
    shortcut = x
    if "proj" in params:
        shortcut = nn.conv2d(params["proj"], pre, stride=stride, dtype=dtype)
    h = nn.conv2d(params["conv1"], pre, stride=1, dtype=dtype)
    h = nn.relu(nn.batchnorm(params["bn2"], h))
    h = nn.conv2d(params["conv2"], h, stride=stride, dtype=dtype)
    h = nn.relu(nn.batchnorm(params["bn3"], h))
    h = nn.conv2d(params["conv3"], h, stride=1, dtype=dtype)
    return h + shortcut


@register("resnet50")
def make_resnet50(image_size: int = 224, num_classes: int = 1000
                  ) -> ModelSpec:
    def init(seed, device, dtype):
        ini = _Init(seed, device, dtype)
        params = {"stem": ini.conv(7, 3, 64)}
        in_ch = 64
        for s, b, stride in _strides():
            params[f"stage{s}_block{b}"] = _block_init(ini, in_ch,
                                                       _WIDTHS[s], stride)
            in_ch = _WIDTHS[s] * _EXPANSION
        params["final_bn"] = ini.bn(in_ch)
        params["head"] = ini.dense(in_ch, num_classes)
        return params

    def apply(params, x, dtype=torch.bfloat16):
        h = nn.conv2d(params["stem"], _nchw(x), stride=2, dtype=dtype)
        h = nn.max_pool(h, 3, 2)
        for s, b, stride in _strides():
            h = _block_apply(params[f"stage{s}_block{b}"], h, stride, dtype)
        h = nn.relu(nn.batchnorm(params["final_bn"], h))
        h = nn.global_avg_pool(h)
        return nn.dense(params["head"], h, dtype=dtype).float()

    return ModelSpec("resnet50", apply=apply, init_fn=init,
                     input_shape=(image_size, image_size, 3),
                     output_shape=(num_classes,))


# -- v1.5 (post-activation) ---------------------------------------------------

def _v1_block_init(init: _Init, in_ch: int, out_ch: int, stride: int):
    mid = out_ch // _EXPANSION
    params = {"conv1": init.conv(1, in_ch, mid), "bn1": init.bn(mid),
              "conv2": init.conv(3, mid, mid), "bn2": init.bn(mid),
              "conv3": init.conv(1, mid, out_ch), "bn3": init.bn(out_ch)}
    if stride != 1 or in_ch != out_ch:
        params["proj"] = init.conv(1, in_ch, out_ch)
        params["proj_bn"] = init.bn(out_ch)
    return params


def _v1_block_apply(params, x, stride: int, dtype):
    shortcut = x
    if "proj" in params:
        shortcut = nn.batchnorm(params["proj_bn"], nn.conv2d(
            params["proj"], x, stride=stride, padding=_NO_PAD, dtype=dtype))
    h = nn.relu(nn.batchnorm(params["bn1"], nn.conv2d(
        params["conv1"], x, stride=1, padding=_NO_PAD, dtype=dtype)))
    h = nn.relu(nn.batchnorm(params["bn2"], nn.conv2d(
        params["conv2"], h, stride=stride, padding=_PAD1, dtype=dtype)))
    h = nn.batchnorm(params["bn3"], nn.conv2d(
        params["conv3"], h, stride=1, padding=_NO_PAD, dtype=dtype))
    return nn.relu(h + shortcut)


@register("resnet50-v1")
def make_resnet50_v1(image_size: int = 224, num_classes: int = 1000
                     ) -> ModelSpec:
    out_chs = tuple(w * _EXPANSION for w in _WIDTHS)

    def init(seed, device, dtype):
        ini = _Init(seed, device, dtype)
        params = {"stem": ini.conv(7, 3, 64), "stem_bn": ini.bn(64)}
        in_ch = 64
        for s, b, stride in _strides():
            params[f"stage{s}_block{b}"] = _v1_block_init(ini, in_ch,
                                                          out_chs[s], stride)
            in_ch = out_chs[s]
        params["head"] = ini.dense(in_ch, num_classes)
        return params

    def apply(params, x, dtype=torch.bfloat16):
        h = nn.conv2d(params["stem"], _nchw(x), stride=2,
                      padding=((3, 3), (3, 3)), dtype=dtype)
        h = nn.relu(nn.batchnorm(params["stem_bn"], h))
        h = nn.max_pool(h, 3, 2, padding=_PAD1)
        for s, b, stride in _strides():
            h = _v1_block_apply(params[f"stage{s}_block{b}"], h, stride,
                                dtype)
        h = nn.global_avg_pool(h)
        return nn.dense(params["head"], h, dtype=dtype).float()

    return ModelSpec("resnet50-v1", apply=apply, init_fn=init,
                     input_shape=(image_size, image_size, 3),
                     output_shape=(num_classes,))
