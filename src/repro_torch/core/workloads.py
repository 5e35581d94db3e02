"""CNN workload shape tables (AlexNet, VGG16, ResNet-50/101/152).
Counterpart of ``repro/core/workloads.py`` (a copy; :class:`GemmShape` is
copied from ``repro/core/analytical.py``, and the port's
:mod:`repro_torch.core.analytical` imports it from here).

The single source of truth for the paper's CNN workloads. Each model is
declared as a structured :class:`ConvSpec` list (plus FC shapes); two
consumers derive from the same tables:

  * the benchmark/analytical layer reads the GEMMs the accelerator's
    in-place conv->GEMM mapping (Algorithm 1) produces:

        M = batch * OH * OW,   K = KH * KW * (Cin/groups),   N = Cout/groups

    (Tables 1-3 reproduce GOPS / GOPS-per-multiplier / ops-per-mult-per-cycle
    on these models);
  * ``repro_torch.vision.models`` builds runnable models (conv topology —
    channels, kernels, strides, pads, groups — comes from these specs; the
    spatial dims recompute from the actual input so smoke-sized inputs flow
    through the same tables).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

from repro_torch.core.im2col import conv_out_hw


@dataclasses.dataclass(frozen=True)
class GemmShape:
    m: int
    k: int
    n: int
    name: str = ""

    def ops(self) -> int:
        """Effective (baseline-equivalent) op count, Eq. (21d): M*N*K
        multiplies and M*N*(K - 1) additions."""
        return self.m * self.n * self.k + self.m * self.n * (self.k - 1)


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One conv layer at its canonical (paper) input resolution. ``stride``
    and ``pad`` are (h, w) pairs; grouped convs declare ``groups`` (AlexNet's
    conv2/4/5 use 2 — the block-diagonal K split in core.im2col)."""
    name: str
    h: int
    w: int
    cin: int
    cout: int
    kh: int
    kw: int
    stride: Tuple[int, int] = (1, 1)
    pad: Tuple[int, int] = (0, 0)
    groups: int = 1

    @property
    def oh(self) -> int:
        return self.out_hw(self.h, self.w)[0]

    @property
    def ow(self) -> int:
        return self.out_hw(self.h, self.w)[1]

    @property
    def k(self) -> int:
        """Contraction dim of the per-group GEMM: KH*KW*(Cin/groups)."""
        return self.kh * self.kw * (self.cin // self.groups)

    def out_hw(self, h: int, w: int) -> Tuple[int, int]:
        """Output spatial dims for an arbitrary (h, w) input (vision models
        run these specs at non-canonical resolutions for smoke tests)."""
        return conv_out_hw(h, w, self.kh, self.kw, self.stride, self.pad)

    def gemm_shapes(self, batch: int = 1) -> List[GemmShape]:
        """The Algorithm-1 GEMM(s) this conv maps to (one per group)."""
        return [GemmShape(
            m=batch * self.oh * self.ow, k=self.k, n=self.cout // self.groups,
            name=f"{self.name}.g{g}" if self.groups > 1 else self.name)
            for g in range(self.groups)]


def conv_gemm(name: str, batch: int, h: int, w: int, cin: int, cout: int,
              kh: int, kw: int, stride: int = 1, pad: int = 0,
              groups: int = 1) -> List[GemmShape]:
    """Back-compat shim: build the GEMM list straight from scalar args."""
    return ConvSpec(name, h, w, cin, cout, kh, kw, (stride, stride),
                    (pad, pad), groups).gemm_shapes(batch)


def fc_gemm(name: str, batch: int, cin: int, cout: int) -> List[GemmShape]:
    return [GemmShape(m=batch, k=cin, n=cout, name=name)]


# ---------------------------------------------------------------------------
# AlexNet (Krizhevsky et al. 2012), original grouped conv2/4/5, ~1.45 GOP.
# ---------------------------------------------------------------------------

def alexnet_convs() -> List[ConvSpec]:
    return [
        ConvSpec("conv1", 227, 227, 3, 96, 11, 11, stride=(4, 4)),
        ConvSpec("conv2", 27, 27, 96, 256, 5, 5, pad=(2, 2), groups=2),
        ConvSpec("conv3", 13, 13, 256, 384, 3, 3, pad=(1, 1)),
        ConvSpec("conv4", 13, 13, 384, 384, 3, 3, pad=(1, 1), groups=2),
        ConvSpec("conv5", 13, 13, 384, 256, 3, 3, pad=(1, 1), groups=2),
    ]


ALEXNET_FCS = [("fc6", 256 * 6 * 6, 4096), ("fc7", 4096, 4096),
               ("fc8", 4096, 1000)]


def alexnet(batch: int = 1) -> List[GemmShape]:
    layers: List[GemmShape] = []
    for spec in alexnet_convs():
        layers += spec.gemm_shapes(batch)
    for name, cin, cout in ALEXNET_FCS:
        layers += fc_gemm(name, batch, cin, cout)
    return layers


# ---------------------------------------------------------------------------
# VGG-16: (cout, repetitions, input resolution) per stage, 3x3 pad-1 convs
# with a 2x2 max-pool between stages.
# ---------------------------------------------------------------------------

VGG16_PLAN = [(64, 2, 224), (128, 2, 112), (256, 3, 56), (512, 3, 28),
              (512, 3, 14)]
VGG16_FCS = [("fc1", 512 * 7 * 7, 4096), ("fc2", 4096, 4096),
             ("fc3", 4096, 1000)]


def vgg16_convs() -> List[ConvSpec]:
    specs: List[ConvSpec] = []
    cin = 3
    idx = 1
    for cout, reps, res in VGG16_PLAN:
        for _ in range(reps):
            specs.append(ConvSpec(f"conv{idx}", res, res, cin, cout, 3, 3,
                                  pad=(1, 1)))
            cin = cout
            idx += 1
    return specs


def vgg16(batch: int = 1) -> List[GemmShape]:
    layers: List[GemmShape] = []
    for spec in vgg16_convs():
        layers += spec.gemm_shapes(batch)
    for name, cin, cout in VGG16_FCS:
        layers += fc_gemm(name, batch, cin, cout)
    return layers


# ---------------------------------------------------------------------------
# ResNet-50/101/152 bottleneck plans. resnet_plan yields one entry per
# bottleneck block so the runnable model and the GEMM tables agree on
# structure (stage width = 64 * 2**stage, expansion 4).
# ---------------------------------------------------------------------------

RESNET_STAGES = {"resnet50": [3, 4, 6, 3], "resnet101": [3, 4, 23, 3],
                 "resnet152": [3, 8, 36, 3]}
RESNET_STEM = ConvSpec("conv1", 224, 224, 3, 64, 7, 7, stride=(2, 2),
                       pad=(3, 3))


@dataclasses.dataclass(frozen=True)
class BottleneckSpec:
    """One ResNet bottleneck: 1x1 reduce -> 3x3 -> 1x1 expand (+ projection
    shortcut on the first block of a stage). ``res`` is the block's OUTPUT
    resolution at the canonical 224 input."""
    name: str
    cin: int
    width: int
    cout: int
    stride: int     # applied by c1 (and proj) on the first block of a stage
    res: int

    @property
    def in_res(self) -> int:
        return self.res * self.stride

    def convs(self) -> List[ConvSpec]:
        r, ir = self.res, self.in_res
        specs = [
            ConvSpec(f"{self.name}.c1", ir, ir, self.cin, self.width, 1, 1,
                     stride=(self.stride, self.stride)),
            ConvSpec(f"{self.name}.c2", r, r, self.width, self.width, 3, 3,
                     pad=(1, 1)),
            ConvSpec(f"{self.name}.c3", r, r, self.width, self.cout, 1, 1),
        ]
        if self.cin != self.cout or self.stride != 1:
            specs.append(ConvSpec(f"{self.name}.proj", ir, ir, self.cin,
                                  self.cout, 1, 1,
                                  stride=(self.stride, self.stride)))
        return specs


def resnet_blocks(blocks_per_stage: List[int]) -> List[BottleneckSpec]:
    blocks: List[BottleneckSpec] = []
    res = 56
    cin = 64
    for stage, n_blocks in enumerate(blocks_per_stage):
        width = 64 * (2 ** stage)
        cout = width * 4
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            blocks.append(BottleneckSpec(f"s{stage + 2}b{b + 1}", cin, width,
                                         cout, stride, res))
            cin = cout
        res //= 2
    return blocks


def _resnet(blocks_per_stage: List[int], batch: int) -> List[GemmShape]:
    layers = RESNET_STEM.gemm_shapes(batch)
    for blk in resnet_blocks(blocks_per_stage):
        for spec in blk.convs():
            layers += spec.gemm_shapes(batch)
    layers += fc_gemm("fc", batch, 2048, 1000)
    return layers


def resnet50(batch: int = 1) -> List[GemmShape]:
    return _resnet(RESNET_STAGES["resnet50"], batch)


def resnet101(batch: int = 1) -> List[GemmShape]:
    return _resnet(RESNET_STAGES["resnet101"], batch)


def resnet152(batch: int = 1) -> List[GemmShape]:
    return _resnet(RESNET_STAGES["resnet152"], batch)


MODELS = {
    "alexnet": alexnet,
    "vgg16": vgg16,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}

# Conv-spec tables for the runnable vision models (and conv tuning/benches).
CONV_SPECS = {
    "alexnet": alexnet_convs,
    "vgg16": vgg16_convs,
    "resnet50": lambda: [RESNET_STEM] + [
        s for blk in resnet_blocks(RESNET_STAGES["resnet50"])
        for s in blk.convs()],
}


def model_gops(name: str, batch: int = 1) -> float:
    return sum(g.ops() for g in MODELS[name](batch)) * 1e-9
