"""Host colour augmentation for --host_normalize (the JAX package's
data/image_aug.py; reference lib/utils/image.py:196-234).

In place on a float32 (H, W, 3) BGR image in [0, 1]: brightness, contrast
and saturation in a shuffled order, then PCA lighting, drawing in the
reference's order. The device path (data/device_aug.py) draws the same
state with `draw_color_aug_params` and applies it on the card.
"""

from __future__ import annotations

import random

import numpy as np

# cv2 BGR2GRAY weights
_BGR_GRAY = np.array([0.114, 0.587, 0.299], np.float32)


def grayscale(image):
    return image @ _BGR_GRAY.astype(image.dtype)


def lighting_(data_rng, image, alphastd, eigval, eigvec):
    alpha = data_rng.normal(scale=alphastd, size=(3,))
    image += np.dot(eigvec, eigval * alpha)


def blend_(alpha, image1, image2):
    image1 *= alpha
    image2 *= (1 - alpha)
    image1 += image2


def saturation_(data_rng, image, gs, gs_mean, var):
    alpha = 1.0 + data_rng.uniform(low=-var, high=var)
    blend_(alpha, image, gs[:, :, None])


def brightness_(data_rng, image, gs, gs_mean, var):
    alpha = 1.0 + data_rng.uniform(low=-var, high=var)
    image *= alpha


def contrast_(data_rng, image, gs, gs_mean, var):
    alpha = 1.0 + data_rng.uniform(low=-var, high=var)
    blend_(alpha, image, gs_mean)


def color_aug(data_rng, image, eig_val, eig_vec, py_random=None):
    """py_random=None shuffles the op order with the process-global python
    `random` (the reference's stream); a numpy RandomState keeps the whole
    draw on that one stream, as `device_aug.draw_color_aug_params` does."""
    functions = [brightness_, contrast_, saturation_]
    if py_random is None:
        random.shuffle(functions)
    else:
        py_random.shuffle(functions)
    gs = grayscale(image)
    gs_mean = gs.mean()
    for f in functions:
        f(data_rng, image, gs, gs_mean, 0.4)
    lighting_(data_rng, image, 0.1, eig_val, eig_vec)
