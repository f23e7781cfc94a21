"""How well conditioned one FP32 train step of the port is, on the CPU.

    python tools_torch/step_conditioning.py [--res 256] [--batch 4]

Takes one train step of the full ShuffleNetV2-DCN 1x model (train-mode BN)
in f32 and in f64 on the same batch of `chip_smoke.py`'s synthetic frames,
from two starts: the port's seeded init, and `chip_smoke.py`'s
`conditioned_init` (the start of its card-vs-CPU parity step). Prints one
JSON line per start: the loss in both precisions, the relative L2 error of
all f32 gradients against the f64 ones, and each tensor's error relative
to its max (floored at 1e-5 of the largest gradient): the median, the
worst, and the worst of the deform blocks' tensors.

Two correct devices that each round in f32 can disagree by about as much
as f32 does from f64, so this says what tolerance a parity check of the
step can hold.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def step_grads(model, trainer, batch, dtype):
    from codenet_torch.data.device_aug import model_input, resolve_targets
    from codenet_torch.engine.trainer import batch_to_device
    model = copy.deepcopy(model).to(dtype).train()
    b = batch_to_device(batch, "cpu")
    inp = model_input(b, trainer.mean, trainer.std)
    b = resolve_targets(b, inp, trainer.opt.down_ratio,
                        trainer.opt.num_classes)
    b = {k: b[k].to(dtype) for k in ("hm", "wh", "reg")} | {
        "ind": b["ind"], "reg_mask": b["reg_mask"]}
    loss, _ = trainer.loss_fn([model(inp.to(dtype))], b, trainer.loss_opts)
    loss.backward()
    return float(loss), {n: p.grad.double()
                         for n, p in model.named_parameters()}


def compare(g32, g64, deform_prefixes):
    num = sum(float(((g32[n] - g64[n]) ** 2).sum()) for n in g64)
    den = sum(float((g ** 2).sum()) for g in g64.values())
    gmax = max(float(g.abs().max()) for g in g64.values())
    per = {n: float((g32[n] - g64[n]).abs().max())
           / max(float(g64[n].abs().max()), 1e-5 * gmax) for n in g64}
    worst = max(per, key=per.get)
    deform = {n: e for n, e in per.items() if n.startswith(deform_prefixes)}
    return {"grad_rel_l2": (num / den) ** 0.5,
            "grad_tensor_rel_median": float(np.median(list(per.values()))),
            "grad_tensor_rel_max": per[worst], "grad_tensor_worst": worst,
            "deform_tensor_rel_max": max(deform.values())}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--res", type=int, default=256)
    parser.add_argument("--batch", type=int, default=4)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from codenet_torch.data.loader import DataLoader
    from codenet_torch.engine.trainer import Trainer

    data = cs.SmokeData(n_train=max(8, args.batch), n_val=2)
    opt = data.opt(args.batch, "--input_res", str(args.res), "--gpus", "-1")
    batch = next(iter(DataLoader(data.dataset(opt), args.batch, shuffle=True,
                                 num_workers=4, seed=1)))
    trainer = Trainer(opt, device="cpu")
    for start, state in (("init", trainer.model.state_dict()),
                         ("conditioned_init", cs.conditioned_init(opt))):
        model = copy.deepcopy(trainer.model)
        model.load_state_dict(state)
        l32, g32 = step_grads(model, trainer, batch, torch.float32)
        l64, g64 = step_grads(model, trainer, batch, torch.float64)
        print(json.dumps({"start": start, "res": args.res,
                          "batch": args.batch, "loss_f32": l32,
                          "loss_f64": l64,
                          **compare(g32, g64, cs.DEFORM_PARAMS)}),
              flush=True)


if __name__ == "__main__":
    main()
