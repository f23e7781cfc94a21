"""The benchmark's yardstick: peaks of the card, the work of a model
image, and what the co-designed deform kernels must move and compute.

Peaks: NVIDIA H100 SXM5 data sheet, dense (no sparsity), at the card's
700 W limit: 3.35 TB/s HBM3, 67 TFLOP/s float32 on the CUDA cores, 494.7
TFLOP/s TF32 on the tensor cores.

The deform counts are those of the program's roofline tool
(`tools_torch/roofline.py`: `deform_fwd_bytes`, `deform_bwd_bytes`,
`FLOPS_PER_OUT`, `BWD_FLOPS_PER_ELEM`), frozen here: they count what the
operation must move and compute, whatever implements it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "tf32": 494.7e12}

# 9 taps x (4 corner mul-adds + 1 tap-weight mul-add) per output element
FLOPS_PER_OUT = 90
# per element of x: 9 taps x (4-corner sample 8, g*w 1, 4 col2im products
# and adds 8, dw FMA 2) + 8 off-centre taps x (4-corner d/ds 8, ds FMA 2)
BWD_FLOPS_PER_ELEM = 9 * (8 + 1 + 8 + 2) + 8 * (8 + 2)


def deform_fwd_bytes(n, h, w, c, itemsize=4, w_itemsize=4):
    """x read and the output written in x's type, s read in f32, the 3x3
    weight read."""
    return 2 * n * h * w * c * itemsize + n * h * w * 4 + 9 * c * w_itemsize


def deform_bwd_bytes(n, h, w, c, itemsize=4):
    """x, g, s and w read once, dx (x's type), ds and dw written once."""
    return 3 * n * h * w * c * itemsize + 2 * n * h * w * 4 \
        + 2 * 9 * c * itemsize


def deform_maps(input_res, w2):
    """(h, w, c) of the three stride-1 deform blocks of the ShuffleNetV2
    neck at a square `input_res`: the stem and three stages take the map
    to input_res / 32, and each block doubles it."""
    side = input_res // 32
    first = 2153 if w2 else 1024
    return [(side, side, first), (2 * side, 2 * side, 256),
            (4 * side, 4 * side, 128)]


def deform_fwd_bound_s(n, maps):
    """The least time of one forward of each of `maps` at batch n, summed:
    each call's larger of bytes over HBM and flops over f32."""
    return sum(max(deform_fwd_bytes(n, h, w, c) / HBM_BYTES_PER_S,
                   n * h * w * c * FLOPS_PER_OUT / PEAK_FLOPS["f32"])
               for h, w, c in maps)


def deform_bwd_bound_s(n, maps):
    """The least time of one backward of each of `maps` at batch n."""
    return sum(max(deform_bwd_bytes(n, h, w, c) / HBM_BYTES_PER_S,
                   n * h * w * c * BWD_FLOPS_PER_ELEM / PEAK_FLOPS["f32"])
               for h, w, c in maps)
