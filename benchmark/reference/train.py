"""The reference's training steps: the image cache's warp and colour
augmentation, the ctdet targets, the network, CenterNet's ctdet loss
(the modified focal loss on the clamped sigmoid, L1 on the sizes weighted
0.1 and on the offsets), its gradient and Adam (torch's form: moments,
bias correction, eps outside the root)."""

from __future__ import annotations

import torch

from . import geometry

BETAS = (0.9, 0.999)
EPS = 1e-8


def model_input(cache_rows, batch, input_hw, mean, std):
    """Normalised (N, 3, H, W) inputs of an image cache batch, whose rows
    `cache_rows` (N, Hc, Wc, 3) uint8 are the frames it names."""
    oh, ow = input_hw
    img = geometry.warp(cache_rows, batch["warp_ti"], oh, ow) / 255.0
    img = geometry.colour_normalise(img, batch["aug_perm"],
                                    batch["aug_alphas"], batch["aug_light"],
                                    mean, std)
    return img.permute(0, 3, 1, 2).contiguous()


def _gather(out, ind):
    n, c, h, w = out.shape
    flat = out.reshape(n, c, h * w)
    return torch.gather(flat, 2, ind.long()[:, None, :].expand(-1, c, -1)
                        ).transpose(1, 2)


def ctdet_loss(out, hm, batch):
    """The loss of the network's heads against the targets."""
    dev = out["hm"].device
    pred = torch.clamp(torch.sigmoid(out["hm"].permute(0, 2, 3, 1)), 1e-4,
                       1 - 1e-4)
    gt = torch.as_tensor(hm, device=dev)
    pos = (gt == 1.0).float()
    neg = (gt < 1.0).float()
    pos_l = (torch.log(pred) * (1 - pred) ** 2 * pos).sum()
    neg_l = (torch.log(1 - pred) * pred ** 2 * (1 - gt) ** 4 * neg).sum()
    npos = pos.sum()
    hm_loss = -neg_l if float(npos) == 0 else -(pos_l + neg_l) / npos
    mask = torch.as_tensor(batch["reg_mask"], device=dev).float()
    ind = torch.as_tensor(batch["ind"], device=dev)

    def l1(head, target):
        p = _gather(out[head], ind)
        m = mask[..., None].expand_as(p)
        t = torch.as_tensor(target, device=dev).float()
        return torch.abs(p * m - t * m).sum() / (m.sum() + 1e-4)
    wh_loss, off_loss = l1("wh", batch["wh"]), l1("reg", batch["reg"])
    return hm_loss + 0.1 * wh_loss + off_loss


class Trainer:
    """The reference's training of configuration `cfg` of architecture
    module `arch` (`arch/`), from `params` and `buffers` (dicts of
    tensors; copied). step(rows, batch) takes one step and returns its
    loss; `first_grads` holds the first step's gradients, `params` the
    current weights. `fault` is one of the module's FAULTS, or None."""

    def __init__(self, arch, cfg, params, buffers, lr, precision="f32",
                 quant=None, fault=None):
        self.cfg = cfg
        self.net = arch.Net(cfg, quant, precision, fault)
        self.params = {k: v.detach().clone().float()
                       for k, v in params.items()}
        self.buffers = {k: v.detach().clone() for k, v in buffers.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.lr = lr
        self.t = 0
        self.first_grads = None

    def loss(self, rows, batch, keep=None):
        """The loss of a batch; `keep` (a slice) takes part of it alone,
        as a step that dropped the rest would."""
        cfg = self.cfg
        if keep is not None:
            batch = {k: v[keep] for k, v in batch.items()}
            rows = rows[keep]
        x = model_input(rows, batch, cfg["input_hw"], cfg["mean"],
                        cfg["std"])
        oh, ow = (side // cfg["down_ratio"] for side in cfg["input_hw"])
        hm = geometry.heatmaps(batch["hm_ct"], batch["hm_radius"],
                               batch["hm_cls"], batch["reg_mask"], oh, ow,
                               cfg["num_classes"])
        out = self.net.forward(x, self.params, self.buffers, train=True,
                               update=True)
        return ctdet_loss(out, hm, batch)

    def step(self, rows, batch, keep=None):
        names = list(self.params)
        leaves = [self.params[k].requires_grad_(True) for k in names]
        loss = self.loss(rows, batch, keep)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        self.t += 1
        b1, b2 = BETAS
        with torch.no_grad():
            if self.first_grads is None:
                self.first_grads = {k: (g if g is not None else
                                        torch.zeros_like(p)).clone()
                                    for k, g, p in zip(names, grads,
                                                       leaves)}
            for k, g, p in zip(names, grads, leaves):
                if g is None:
                    continue
                m, v = self.m[k], self.v[k]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / (1 - b2 ** self.t) ** 0.5).add_(EPS)
                self.params[k] = (p - (self.lr / (1 - b1 ** self.t))
                                  * m / denom).detach()
        return float(loss.detach())
