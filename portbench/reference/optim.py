"""The first steps of a job, retraced by torch's own optimizers.

Adam is ``torch.optim.Adam`` (betas 0.9, 0.999, eps 1e-8) with the
reference repository's learning rate, lr_start * decay^(k+1) at step k.
L-BFGS is ``torch.optim.LBFGS(max_iter=1, line_search_fn='strong_wolfe')``,
its search given lbfgs_max_ls_steps evaluations, with the reference's
closure, which decays the learning rate on every
evaluation: torch reads the rate once at the top of each step, so step k
opens its search at lr_start * decay^(evaluations before it), and its
first search at min(1, 1 / |g|_1) times that. Both run on one flattened
image in float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .model import Objective


def retrace(objective: Objective, x0: torch.Tensor, cfg: dict,
            steps: int) -> Dict[str, object]:
    """Run `steps` optimizer steps from the (1, n) start x0. Returns the
    image after them ('x', (1, n)), the loss the program reports with
    that chunk ('f_chunk': the last evaluation's loss for Adam, the loss
    at the new image for L-BFGS) and the number of evaluations."""
    x = x0.detach().clone().requires_grad_(True)
    decay = float(cfg["lr_decay"])
    lr0 = float(cfg["lr_start"])
    evals = 0
    if cfg["optimizer"] == "adam":
        opt = torch.optim.Adam([x], lr=lr0, betas=(0.9, 0.999), eps=1e-8)
        f = None
        for k in range(steps):
            opt.param_groups[0]["lr"] = float(
                np.float32(lr0 * np.power(np.float32(decay),
                                          np.float32(k + 1.0))))
            opt.zero_grad()
            loss = objective.loss(x)[0]
            loss.backward()
            evals += 1
            f = float(loss.detach())
            opt.step()
        return {"x": x.detach(), "f_chunk": f, "evals": evals}
    if cfg["optimizer"] != "lbfgs":
        raise ValueError(f"unknown optimizer {cfg['optimizer']!r}")
    if not cfg["lr_decay_per_eval"] or cfg["lbfgs_t_init"] != "lr":
        raise ValueError("the reference retraces the reference's L-BFGS: "
                         "per-evaluation decay, searches opened at lr")
    # torch gives the search max_eval less the step's first evaluation
    opt = torch.optim.LBFGS([x], lr=lr0, max_iter=1,
                            max_eval=1 + int(cfg["lbfgs_max_ls_steps"]),
                            history_size=int(cfg["lbfgs_history"]),
                            line_search_fn="strong_wolfe")
    group = opt.param_groups[0]

    def closure():
        nonlocal evals
        evals += 1
        opt.zero_grad()
        loss = objective.loss(x)[0]
        loss.backward()
        group["lr"] = group["lr"] * decay
        return loss

    for _ in range(steps):
        opt.step(closure)
    with torch.no_grad():
        f = float(objective.loss(x)[0])
    return {"x": x.detach(), "f_chunk": f, "evals": evals}
