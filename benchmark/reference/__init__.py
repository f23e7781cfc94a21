"""The plain reference of the benchmark: ctdet (CenterNet's letterbox,
warp and augmentation, targets, loss, Adam and decode) over one network
module per architecture (`arch/`), written out in plain PyTorch and
NumPy, float32.

It imports nothing of the program under test (`codenet_torch`, its tools)
and nothing of JAX or the JAX package. Where it needs the program's plain
formulations (the letterbox geometry, the device warp, the colour
augmentation, the co-designed deform op, W4A8 fake-quant, the decode) it
holds frozen copies of them, written again op by op: gathers for the
deform, a hand-written Adam, per-head heads. It reads only the inputs and
the weights that the benchmark hands to both sides, and works every
derived quantity (warps, heatmaps, folded weights, quantizer ranges) out
again.

`precision` selects the arithmetic of every convolution: "f32" (TF32
off), or "tf32", the control: each convolution's operands rounded to
TF32's 10-bit mantissa before an f32 convolution, as the card's TF32 path
rounds them.
"""
