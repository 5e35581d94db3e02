"""Algorithm 1: in-place mapping of 2-D convolution to GEMM (§5.1).
Counterpart of ``repro/core/im2col.py``.

The paper's memory subsystem walks conv inputs with multi-digit counters
(programmable digit sizes and strides, Fig. 5), so the systolic array sees a
GEMM without a separate im2col re-layout stage. Here:

  * :class:`MultiDigitCounter`: the Fig.-5 counter (nested digits, each with
    a size and a stride; the emitted address is the sum of digit values),
  * :func:`conv_gemm_indices`: Algorithm 1 for NHWC conv, the (M, K) gather
    indices into the padded input (numpy, equal to the reference's),
  * :func:`conv2d_via_gemm`: materialises A through the indices and runs
    any GEMM (baseline / FIP / FFIP): the oracle of the fused kernel K7,
  * :func:`partition_blocks`: the §5.1.1 B-way memory partitioning of the W
    dimension (interleaved submemories), with the kw-crossing adjustment.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

Size2 = Union[int, Tuple[int, int], Sequence[int]]


def as_pair(v: Size2) -> Tuple[int, int]:
    """Normalize a stride/padding argument to an (h, w) pair; a single int
    means symmetric."""
    if isinstance(v, (tuple, list)):
        if len(v) != 2:
            raise ValueError(f"expected (h, w) pair, got {v!r}")
        return int(v[0]), int(v[1])
    return int(v), int(v)


def conv_out_hw(h: int, w: int, kh: int, kw: int, stride: Size2 = 1,
                pad: Size2 = 0) -> Tuple[int, int]:
    """Conv/pool output spatial dims, the one output-size formula of the
    workload tables, the fused kernel and the vision layers."""
    sh, sw = as_pair(stride)
    ph, pw = as_pair(pad)
    return (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1


@dataclasses.dataclass
class Digit:
    """One digit of the Fig.-5 counter: iterates size times with a stride."""
    name: str
    size: int
    stride: int


class MultiDigitCounter:
    """Nested multi-digit counter, outer digits first (Algorithm 1's loop
    order). Emitted value = sum of (digit index * stride) over the digits:
    the ``address = m_offset + k_offset`` composition of Algorithm 1."""

    def __init__(self, digits: Sequence[Digit]):
        self.digits = list(digits)

    def addresses(self) -> np.ndarray:
        grids = np.meshgrid(
            *[np.arange(d.size) * d.stride for d in self.digits],
            indexing="ij")
        out = np.zeros_like(grids[0])
        for g in grids:
            out = out + g
        return out.reshape(-1)


def conv_gemm_indices(h: int, w: int, cin: int, kh: int, kw: int,
                      stride: Size2 = 1, *, groups: int = 1,
                      group: int = 0) -> np.ndarray:
    """Algorithm-1 address pattern for one image: (M, K) indices into the
    flattened (H, W, Cin) input, M = OH*OW, K = KH*KW*(Cin/groups).

    The kernel-offset digits (kh, kw, cin) form K (k_offset), the spatial
    digits (h, w) form M (m_offset), and the address is their sum. For a
    grouped conv the cin digit walks the group's channel slice and ``group``
    adds the constant channel offset."""
    sh, sw = as_pair(stride)
    if cin % groups:
        raise ValueError(f"cin={cin} not divisible by groups={groups}")
    cin_g = cin // groups
    oh, ow = conv_out_hw(h, w, kh, kw, (sh, sw))
    m_counter = MultiDigitCounter([
        Digit("h", oh, sh * w * cin),
        Digit("w", ow, sw * cin),
    ])
    k_counter = MultiDigitCounter([
        Digit("kh", kh, w * cin),
        Digit("kw", kw, cin),
        Digit("cin", cin_g, 1),
    ])
    m_off = m_counter.addresses()
    k_off = k_counter.addresses() + group * cin_g
    return m_off[:, None] + k_off[None, :]


def conv2d_via_gemm(x: Tensor, kernel: Tensor, *, stride: Size2 = 1,
                    pad: Size2 = 0, groups: int = 1,
                    gemm_fn: Optional[Callable[[Tensor, Tensor], Tensor]]
                    = None) -> Tensor:
    """NHWC conv via the Algorithm-1 GEMM mapping (the materialising
    reference). x: (B, H, W, Cin); kernel: (KH, KW, Cin/groups, Cout) ->
    (B, OH, OW, Cout). A grouped conv is the block-diagonal K split: group g
    contracts its own K against its own Cout/groups weight columns."""
    if gemm_fn is None:
        gemm_fn = torch.matmul
    b_, h, w, cin = x.shape
    kh, kw, cin_g, cout = kernel.shape
    if groups * cin_g != cin:
        raise ValueError(f"kernel expects cin/groups={cin_g}, "
                         f"got cin={cin} groups={groups}")
    if cout % groups:
        raise ValueError(f"cout={cout} not divisible by groups={groups}")
    sh, sw = as_pair(stride)
    ph, pw = as_pair(pad)
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
        h, w = h + 2 * ph, w + 2 * pw
    oh, ow = conv_out_hw(h, w, kh, kw, (sh, sw))
    flat = x.reshape(b_, h * w * cin)
    ng = cout // groups
    bmat = kernel.reshape(kh * kw * cin_g, cout)
    outs = []
    for g in range(groups):
        idx = torch.from_numpy(conv_gemm_indices(
            h, w, cin, kh, kw, (sh, sw), groups=groups, group=g)).to(x.device)
        a = flat[:, idx]                                 # (B, M, K) gather
        outs.append(gemm_fn(a, bmat[:, g * ng:(g + 1) * ng]))
    c = outs[0] if groups == 1 else torch.cat(outs, dim=-1)
    return c.reshape(b_, oh, ow, cout)


# ---------------------------------------------------------------------------
# §5.1.1: B-way memory partitioning of the W dimension
# ---------------------------------------------------------------------------

def partition_blocks(w_indices: np.ndarray, ws: int,
                     n_blocks: int) -> List[np.ndarray]:
    """Split a stream of w-coordinates into B interleaved submemory streams:
    W slice s (``ws`` elements wide) goes to block s % B."""
    slice_id = w_indices // ws
    return [w_indices[slice_id % n_blocks == b] for b in range(n_blocks)]


def interleave_blocks(blocks: List[np.ndarray],
                      order: Optional[np.ndarray] = None) -> np.ndarray:
    """Round-robin re-interleave (the main-clock view). ``order`` permutes
    the block visiting order: the §5.1.1 kw-crossing adjustment rotates it
    when a kernel-window read starts inside a different block."""
    n = len(blocks)
    if order is None:
        order = np.arange(n)
    max_len = max(len(b) for b in blocks)
    out = []
    for i in range(max_len):
        for j in order:
            if i < len(blocks[j]):
                out.append(blocks[j][i])
    return np.asarray(out)
