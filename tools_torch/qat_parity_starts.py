"""How the QAT step's card-vs-CPU parity depends on its start, on a card.

    python tools_torch/qat_parity_starts.py [--trained 6] [--conditioned 3]

Takes `chip_smoke.py`'s QAT parity step (one W4A8 train step at batch 4,
256², on the card and on the CPU from the same weights and batch,
`chip_smoke.step_parity`) from two kinds of start, each loaded into the
quantized model through the port's checkpoint as `chip_smoke.phase_qat`
loads its FP32 weights:

- trained: the port's init after 12 FP32 steps at batch 32 on the card,
  a fresh training for each start (`chip_smoke.timed_steps`);
- conditioned: `chip_smoke.conditioned_init` (BN biases raised by 3).

Prints one JSON line per start: whether the step holds chip_smoke's
5e-3 (loss, all gradients, the median tensor, each deform-block tensor),
and those numbers with the worst tensor.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trained", type=int, default=6)
    parser.add_argument("--conditioned", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("qat_parity_starts.py needs a CUDA card; none is visible")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from codenet_torch.data.loader import DataLoader
    from codenet_torch.engine import checkpoint
    from codenet_torch.engine.trainer import Trainer
    from codenet_torch.models import create_model
    from codenet_torch.models.layers import QuantSpec

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data = cs.SmokeData()
    opt = data.opt(cs.TRAIN_BATCH)
    loader = DataLoader(data.dataset(opt), cs.TRAIN_BATCH, shuffle=True,
                        num_workers=opt.num_workers, seed=opt.seed)
    batches = []
    while len(batches) < 12:
        batches.extend(loader)
    path = str(ROOT / "exp" / "chip_smoke" / "qat_start.pth")

    def parity(model, label):
        checkpoint.save_model(path, 1, model)
        trainer = Trainer(opt, qspec=QuantSpec(), device="cuda")
        with contextlib.redirect_stdout(io.StringIO()):
            checkpoint.load_model(path, trainer.model)
        out, ok = cs.step_parity(data, trainer.model.state_dict(),
                                 QuantSpec())
        deform = out.pop("deform_tensor_rel")
        worst = max(deform, key=deform.get)
        print(json.dumps({"start": label, "holds": ok, **out,
                          "deform_tensor_rel_max": deform[worst],
                          "deform_tensor_worst": worst}), flush=True)

    for k in range(args.trained):
        trainer = Trainer(opt, device="cuda")
        trainer.init()
        cs.timed_steps(trainer, batches[:12])
        parity(trainer.model, "trained{}".format(k))
    model = create_model(opt.arch, opt.heads, opt.head_conv, device="cpu")
    model.load_state_dict(cs.conditioned_init(opt))
    for k in range(args.conditioned):
        parity(model, "conditioned{}".format(k))


if __name__ == "__main__":
    main()
