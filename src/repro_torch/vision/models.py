"""Runnable CNN models built from the ``core.workloads`` conv-spec tables.
Counterpart of ``repro/vision/models.py``.

Channels, kernels, strides, pads and groups come from the tables; spatial
dims follow the actual input, so a smoke-sized image flows through the same
topology (``width_div`` shrinks channel counts; the FC input dim is inferred,
never hardcoded). Every conv goes through :func:`repro_torch.vision.layers.
conv2d`, i.e. through the ambient GemmConfig: ``use_gemm(GemmConfig(
algo="ffip", impl="cuda", quantized=True))`` puts the whole model on the
fused int8 conv kernel K7, with no model change.

LRN (AlexNet) is omitted and BN (ResNet) initializes pre-folded, as the
deployment flow would have them; :func:`attach_quantized` folds given BN
statistics and quantizes whatever the folded weights are.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import workloads
from repro_torch.core.im2col import conv_out_hw
from repro_torch.kernels import compat
from repro_torch.models.layers import dense, dense_init
from repro_torch.vision import layers as vl

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Layer descriptors (static topology; params live in a parallel list)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    kh: int
    kw: int
    cin: int
    cout: int
    stride: Tuple[int, int] = (1, 1)
    pad: Tuple[int, int] = (0, 0)
    groups: int = 1
    relu: bool = True


@dataclasses.dataclass(frozen=True)
class MaxPool:
    size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    pad: Tuple[int, int] = (0, 0)


@dataclasses.dataclass(frozen=True)
class GlobalAvgPool:
    pass


@dataclasses.dataclass(frozen=True)
class Flatten:
    pass


@dataclasses.dataclass(frozen=True)
class FC:
    name: str
    cin: int
    cout: int
    relu: bool = False


@dataclasses.dataclass(frozen=True)
class Bottleneck:
    """ResNet bottleneck: c1 -> c2 -> c3 (+ optional projection shortcut),
    ReLU after the residual add."""
    name: str
    c1: Conv
    c2: Conv
    c3: Conv
    proj: Optional[Conv] = None


Layer = Union[Conv, MaxPool, GlobalAvgPool, Flatten, FC, Bottleneck]
_BOTTLENECK_CONVS = ("c1", "c2", "c3", "proj")


def _conv_apply(x: Tensor, layer: Conv, p: dict) -> Tensor:
    out = vl.conv2d(x, p, stride=layer.stride, pad=layer.pad,
                    groups=layer.groups)
    return vl.relu(out) if layer.relu else out


def init_params(model: Sequence[Layer], seed: int = 0, *,
                dtype=torch.float32, device=None) -> list:
    """One params entry per layer (None for parameterless layers), drawn
    from a generator seeded with ``seed`` on ``device`` (``None``: the
    card)."""
    device = compat.resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: list = []
    for layer in model:
        if isinstance(layer, Conv):
            params.append(vl.conv_init(gen, layer.kh, layer.kw, layer.cin,
                                       layer.cout, groups=layer.groups,
                                       dtype=dtype, device=device))
        elif isinstance(layer, FC):
            params.append(dense_init(gen, layer.cin, layer.cout, dtype,
                                     device=device, bias=True))
        elif isinstance(layer, Bottleneck):
            params.append({
                field: vl.conv_init(gen, conv.kh, conv.kw, conv.cin,
                                    conv.cout, groups=conv.groups,
                                    dtype=dtype, device=device)
                for field in _BOTTLENECK_CONVS
                for conv in [getattr(layer, field)] if conv is not None})
        else:
            params.append(None)
    return params


def apply(model: Sequence[Layer], params: Sequence, x: Tensor) -> Tensor:
    """Forward pass: (B, H, W, Cin) image -> (B, num_classes) logits."""
    for layer, p in zip(model, params):
        if isinstance(layer, Conv):
            x = _conv_apply(x, layer, p)
        elif isinstance(layer, MaxPool):
            x = vl.maxpool2d(x, size=layer.size, stride=layer.stride,
                             pad=layer.pad)
        elif isinstance(layer, GlobalAvgPool):
            x = vl.global_avgpool(x)
        elif isinstance(layer, Flatten):
            x = x.reshape(x.shape[0], -1)
        elif isinstance(layer, FC):
            x = dense(x, p)
            if layer.relu:
                x = vl.relu(x)
        elif isinstance(layer, Bottleneck):
            y = _conv_apply(x, layer.c1, p["c1"])
            y = _conv_apply(y, layer.c2, p["c2"])
            y = _conv_apply(y, layer.c3, p["c3"])
            sc = (_conv_apply(x, layer.proj, p["proj"])
                  if layer.proj is not None else x)
            x = vl.relu(y + sc)
        else:
            raise TypeError(f"unknown layer {layer!r}")
    return x


def attach_quantized(model: Sequence[Layer], params: Sequence, *,
                     bn_stats: Optional[Sequence] = None,
                     dtype=torch.int8) -> list:
    """Offline int8 preparation of a whole vision model (the layer loop of
    the reference's ``prepare.prepare_vision``): BN folded into the convs
    first when ``bn_stats`` (per layer: a gamma/beta/mean/var dict or None,
    parallel to ``params``) is given, then each conv's int8 entry on the
    flattened KH*KW*Cin_g axis and each even-K FC's serving entry."""
    p = list(params)
    if bn_stats is not None:
        if len(bn_stats) != len(p):
            raise ValueError("bn_stats must be parallel to params")
        p = [vl.fold_bn(lp, bn) if bn is not None else lp
             for lp, bn in zip(p, bn_stats)]
    out: list = []
    for layer, lp in zip(model, p):
        if isinstance(layer, Conv):
            out.append(vl.attach_quantized_conv(lp, groups=layer.groups,
                                                dtype=dtype))
        elif isinstance(layer, FC):
            out.append(vl.attach_quantized_fc(lp, dtype=dtype))
        elif isinstance(layer, Bottleneck):
            entry = dict(lp)
            for field in _BOTTLENECK_CONVS:
                conv = getattr(layer, field)
                if conv is not None:
                    entry[field] = vl.attach_quantized_conv(
                        lp[field], groups=conv.groups, dtype=dtype)
            out.append(entry)
        else:
            out.append(lp)
    return out


def conv_layers(model: Sequence[Layer]) -> List[Conv]:
    """All convs in the model, bottlenecks flattened."""
    convs: List[Conv] = []
    for layer in model:
        if isinstance(layer, Conv):
            convs.append(layer)
        elif isinstance(layer, Bottleneck):
            convs += [c for c in (layer.c1, layer.c2, layer.c3, layer.proj)
                      if c is not None]
    return convs


def conv_geometries(model: Sequence[Layer],
                    image_size: int) -> List[Tuple[Conv, int, int]]:
    """(conv, input_h, input_w) for every conv, tracking the spatial flow
    from ``image_size``."""
    out: List[Tuple[Conv, int, int]] = []
    h = w = image_size
    for layer in model:
        if isinstance(layer, Conv):
            out.append((layer, h, w))
        elif isinstance(layer, Bottleneck):
            bh, bw = h, w
            for conv in (layer.c1, layer.c2, layer.c3):
                out.append((conv, bh, bw))
                bh, bw = _spatial(conv, bh, bw)
            if layer.proj is not None:
                out.append((layer.proj, h, w))
        h, w = _spatial(layer, h, w)
    return out


# ---------------------------------------------------------------------------
# Builders from the workload tables
# ---------------------------------------------------------------------------

def _div_ch(c: int, div: int, groups: int = 1) -> int:
    """Shrink a channel count for smoke models, keeping it a positive
    multiple of 2*groups (grouped convs stay grouped, K stays evenizable)."""
    unit = 2 * groups
    return max(unit, (c // div) // unit * unit)


def _spatial(layer, h: int, w: int) -> Tuple[int, int]:
    if isinstance(layer, Conv):
        return conv_out_hw(h, w, layer.kh, layer.kw, layer.stride, layer.pad)
    if isinstance(layer, MaxPool):
        return conv_out_hw(h, w, layer.size[0], layer.size[1], layer.stride,
                           layer.pad)
    if isinstance(layer, Bottleneck):
        for conv in (layer.c1, layer.c2, layer.c3):
            h, w = _spatial(conv, h, w)
        return h, w
    return h, w


def _conv_from_spec(spec: workloads.ConvSpec, cin: int, cout: int,
                    relu: bool = True) -> Conv:
    return Conv(spec.name, spec.kh, spec.kw, cin, cout, spec.stride,
                spec.pad, spec.groups, relu)


def build_alexnet(num_classes: int = 1000, image_size: int = 227,
                  width_div: int = 1) -> List[Layer]:
    """AlexNet from workloads.alexnet_convs() (grouped conv2/4/5; LRN
    omitted). Pools after conv1/conv2/conv5 as in the original."""
    specs = {s.name: s for s in workloads.alexnet_convs()}
    chans = {}
    for name in ("conv1", "conv2", "conv3", "conv4", "conv5"):
        s = specs[name]
        chans[name] = _div_ch(s.cout, width_div, s.groups)
    model: List[Layer] = []
    cin = 3
    h = w = image_size
    for name in ("conv1", "conv2", "conv3", "conv4", "conv5"):
        s = specs[name]
        conv = _conv_from_spec(s, cin, chans[name])
        model.append(conv)
        h, w = _spatial(conv, h, w)
        cin = chans[name]
        if name in ("conv1", "conv2", "conv5") and min(h, w) >= 3:
            pool = MaxPool((3, 3), (2, 2))
            model.append(pool)
            h, w = _spatial(pool, h, w)
    model.append(Flatten())
    flat = h * w * cin
    fcs = workloads.ALEXNET_FCS
    d6 = _div_ch(fcs[0][2], width_div)
    d7 = _div_ch(fcs[1][2], width_div)
    model += [FC("fc6", flat, d6, relu=True), FC("fc7", d6, d7, relu=True),
              FC("fc8", d7, num_classes)]
    return model


def build_vgg16(num_classes: int = 1000, image_size: int = 224,
                width_div: int = 1) -> List[Layer]:
    """VGG-16 from workloads.VGG16_PLAN (3x3 pad-1 stacks + 2x2 pools)."""
    model: List[Layer] = []
    cin = 3
    h = w = image_size
    n_convs = 0
    for cout, reps, _res in workloads.VGG16_PLAN:
        cd = _div_ch(cout, width_div)
        for _ in range(reps):
            n_convs += 1
            conv = Conv(f"conv{n_convs}", 3, 3, cin, cd, pad=(1, 1))
            model.append(conv)
            h, w = _spatial(conv, h, w)
            cin = cd
        if min(h, w) >= 2:
            pool = MaxPool((2, 2), (2, 2))
            model.append(pool)
            h, w = _spatial(pool, h, w)
    model.append(Flatten())
    flat = h * w * cin
    d1 = _div_ch(workloads.VGG16_FCS[0][2], width_div)
    d2 = _div_ch(workloads.VGG16_FCS[1][2], width_div)
    model += [FC("fc1", flat, d1, relu=True), FC("fc2", d1, d2, relu=True),
              FC("fc3", d2, num_classes)]
    return model


def build_resnet50(num_classes: int = 1000, image_size: int = 224,
                   width_div: int = 1) -> List[Layer]:
    """ResNet-50 from workloads.resnet_blocks (bottlenecks with projection
    shortcuts; BN pre-folded into the convs)."""
    del image_size                      # spatial dims follow the input
    stem_spec = workloads.RESNET_STEM
    c_stem = _div_ch(stem_spec.cout, width_div)
    model: List[Layer] = [
        _conv_from_spec(stem_spec, 3, c_stem),
        MaxPool((3, 3), (2, 2), pad=(1, 1)),
    ]
    cin = c_stem
    for blk in workloads.resnet_blocks(workloads.RESNET_STAGES["resnet50"]):
        width = _div_ch(blk.width, width_div)
        cout = _div_ch(blk.cout, width_div)
        st = (blk.stride, blk.stride)
        c1 = Conv(f"{blk.name}.c1", 1, 1, cin, width, stride=st)
        c2 = Conv(f"{blk.name}.c2", 3, 3, width, width, pad=(1, 1))
        c3 = Conv(f"{blk.name}.c3", 1, 1, width, cout, relu=False)
        proj = (Conv(f"{blk.name}.proj", 1, 1, cin, cout, stride=st,
                     relu=False)
                if (cin != cout or blk.stride != 1) else None)
        model.append(Bottleneck(blk.name, c1, c2, c3, proj))
        cin = cout
    model += [GlobalAvgPool(), FC("fc", cin, num_classes)]
    return model


BUILDERS = {
    "alexnet": build_alexnet,
    "vgg16": build_vgg16,
    "resnet50": build_resnet50,
}


def default_image_size(name: str) -> int:
    return 227 if name == "alexnet" else 224


def build(name: str, *, num_classes: int = 1000, image_size: int = 0,
          width_div: int = 1) -> List[Layer]:
    if name not in BUILDERS:
        raise ValueError(f"unknown vision model {name!r}; "
                         f"have {sorted(BUILDERS)}")
    return BUILDERS[name](num_classes=num_classes,
                          image_size=image_size or default_image_size(name),
                          width_div=width_div)
