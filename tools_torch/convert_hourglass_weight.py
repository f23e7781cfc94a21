#!/usr/bin/env python
"""Rename an ExtremeNet hourglass checkpoint's head keys to CenterNet's
exdet names (reference tools/convert_hourglass_weight.py; the port's copy
of the JAX package's tool, which writes the same file): t_heats, l_heats,
b_heats, r_heats and ct_heats become hm_t, hm_l, hm_b, hm_r and hm_c, and
the *_regrs become reg_*; 'ct_heats' keeps its own rule, not the
't_heats' one it contains. Writes {'epoch': 0, 'state_dict'}, which
`--load_model` reads.

  python tools_torch/convert_hourglass_weight.py ExtremeNet_500000.pkl \\
      exp/exdet/ExtremeNet_500000.pth
"""

import argparse
import sys

KEY_MAP = {"t_heats": "hm_t", "l_heats": "hm_l", "b_heats": "hm_b",
           "r_heats": "hm_r", "ct_heats": "hm_c",
           "t_regrs": "reg_t", "l_regrs": "reg_l",
           "b_regrs": "reg_b", "r_regrs": "reg_r"}


def convert_state_dict(state_dict):
    """The reference's rename rules over a mapping of parameter names: a
    key that several rules match is written once under each."""
    out = {}
    for key, value in state_dict.items():
        changed = False
        for old, new in KEY_MAP.items():
            if old not in key or ("ct_heats" in key and old == "t_heats"):
                continue
            out[key.replace(old, new)] = value
            changed = True
        if not changed:
            out[key] = value
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("model_path")
    ap.add_argument("out_path")
    args = ap.parse_args(argv)
    import torch
    # the ExtremeNet release is a pickle of tensors, not a weights-only
    # file
    state_dict = torch.load(args.model_path, map_location="cpu",
                            weights_only=False)
    if isinstance(state_dict, dict) and "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    out = convert_state_dict(state_dict)
    renamed = sum(1 for k in out if k not in state_dict)
    torch.save({"epoch": 0, "state_dict": out}, args.out_path)
    print("renamed {} keys -> {}".format(renamed, args.out_path))
    return 0


if __name__ == "__main__":
    sys.exit(main())
