"""3D box geometry of the KITTI ddd task, host numpy (the JAX package's
utils/ddd_utils.py; reference lib/utils/ddd_utils.py).

Camera-frame 3D box <-> image projection, alpha <-> rotation_y, and the
2D -> 3D unprojection at a known depth through a 3x4 calibration matrix,
and `draw_box_3d`, the wireframe of --debug renders (cv2, imported when
it draws).
"""

from __future__ import annotations

import numpy as np


def compute_box_3d(dim, location, rotation_y):
    """8 corners (8, 3) of a 3D box (dim = [h, w, l]) in camera coords."""
    c, s = np.cos(rotation_y), np.sin(rotation_y)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)
    l, w, h = dim[2], dim[1], dim[0]
    x_corners = [l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]
    y_corners = [0, 0, 0, 0, -h, -h, -h, -h]
    z_corners = [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]
    corners = np.array([x_corners, y_corners, z_corners], dtype=np.float32)
    corners_3d = np.dot(R, corners) + np.array(
        location, dtype=np.float32).reshape(3, 1)
    return corners_3d.transpose(1, 0)


def project_to_image(pts_3d, P):
    """(n, 3) camera points -> (n, 2) pixels through the 3x4 P."""
    pts_3d_homo = np.concatenate(
        [pts_3d, np.ones((pts_3d.shape[0], 1), dtype=np.float32)], axis=1)
    pts_2d = np.dot(P, pts_3d_homo.transpose(1, 0)).transpose(1, 0)
    return pts_2d[:, :2] / pts_2d[:, 2:]


def draw_box_3d(image, corners, c=(0, 0, 255)):
    """Wireframe a projected 3D box (reference ddd_utils.py:53-68) into
    `image` in place; (8, 2) int corners from project_to_image."""
    import cv2
    face_idx = [[0, 1, 5, 4], [1, 2, 6, 5], [2, 3, 7, 6], [3, 0, 4, 7]]
    for ind_f in range(3, -1, -1):
        f = face_idx[ind_f]
        for j in range(4):
            cv2.line(image, (corners[f[j], 0], corners[f[j], 1]),
                     (corners[f[(j + 1) % 4], 0], corners[f[(j + 1) % 4], 1]),
                     c, 2, lineType=cv2.LINE_AA)
        if ind_f == 0:
            cv2.line(image, (corners[f[0], 0], corners[f[0], 1]),
                     (corners[f[2], 0], corners[f[2], 1]), c, 1,
                     lineType=cv2.LINE_AA)
            cv2.line(image, (corners[f[1], 0], corners[f[1], 1]),
                     (corners[f[3], 0], corners[f[3], 1]), c, 1,
                     lineType=cv2.LINE_AA)
    return image


def unproject_2d_to_3d(pt_2d, depth, P):
    """Invert the pinhole projection at a known depth."""
    z = depth - P[2, 3]
    x = (pt_2d[0] * depth - P[0, 3] - P[0, 2] * z) / P[0, 0]
    y = (pt_2d[1] * depth - P[1, 3] - P[1, 2] * z) / P[1, 1]
    return np.array([x, y, z], dtype=np.float32)


def alpha2rot_y(alpha, x, cx, fx):
    """Observation angle -> global yaw, wrapped to [-pi, pi]."""
    rot_y = alpha + np.arctan2(x - cx, fx)
    if rot_y > np.pi:
        rot_y -= 2 * np.pi
    if rot_y < -np.pi:
        rot_y += 2 * np.pi
    return rot_y


def rot_y2alpha(rot_y, x, cx, fx):
    """Global yaw -> observation angle, wrapped to [-pi, pi]."""
    alpha = rot_y - np.arctan2(x - cx, fx)
    if alpha > np.pi:
        alpha -= 2 * np.pi
    if alpha < -np.pi:
        alpha += 2 * np.pi
    return alpha


def ddd2locrot(center, alpha, dim, depth, calib):
    """Box centre pixel, alpha, dim and depth -> the 3D location (bottom
    centre) and rotation_y."""
    locations = unproject_2d_to_3d(center, depth, calib)
    locations[1] += dim[0] / 2
    rotation_y = alpha2rot_y(alpha, center[0], calib[0, 2], calib[0, 0])
    return locations, rotation_y


def project_3d_bbox(location, dim, rotation_y, calib):
    return project_to_image(compute_box_3d(dim, location, rotation_y), calib)
