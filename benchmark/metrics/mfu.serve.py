"""mfu.serve: the whole served forward's share of the card's peak: the
configuration's frozen forward MACs an image x 2 FLOPs x 2 (the flipped
copy) x the traced run's frames a second, over the peak of the
configuration's precision (float32, TF32 off: 67 TFLOP/s), in %."""

from benchmark import counts


def read(r):
    rate = r.values.get("serve_img_per_s")
    if not rate:
        return None
    copies = 2 if r.cell.workload.get("flip_test") else 1
    flops = r.cell.config["macs_per_image"] * 2 * copies * rate
    return 100.0 * flops / (counts.PEAK_FLOPS["f32"] * r.cell.chips)
