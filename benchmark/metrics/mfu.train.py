"""mfu.train: the whole train step's share of the card's peak: the
configuration's frozen forward MACs an image x 2 FLOPs x 3 (forward and
backward) x the traced run's images a second, over the peak of the
configuration's precision (float32, TF32 off: 67 TFLOP/s) times the
cell's cards, in %."""

from benchmark import counts


def read(r):
    rate = r.values.get("train_img_per_s")
    if not rate:
        return None
    flops = r.cell.config["macs_per_image"] * 2 * 3 * rate
    return 100.0 * flops / (counts.PEAK_FLOPS["f32"] * r.cell.chips)
