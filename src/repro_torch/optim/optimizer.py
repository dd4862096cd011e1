"""AdamW with the reference's mixed-precision policy (``repro.optim``).

* master weights: fp32;
* Adam moments: fp32 or bf16 (the reference plan's ``optimizer_dtype``);
* compute and gradients: the compute dtype, carried back to fp32 by the
  cast's backward before they reach the update.

Same schedule (linear warmup, cosine decay), global-norm clip, bias
correction and decoupled weight decay as the JAX package.  Unlike it, the
update works IN PLACE on the master weights and both moments and uses the
gradient as its one scratch buffer, so a step allocates no leaf-sized
temporary: at granite-moe-3b's full width an expert leaf is 4 GB in fp32,
and the reference's per-leaf expression would form about six of them.
bf16 moments keep the reference's arithmetic (upcast m and v, form the new
moments and the step in fp32, round the moments once when storing them)
on slices of at most ``UPDATE_SLICE`` elements, so the fp32 copies of m and
v are slice-sized, never leaf-sized.  The step counter is a 0-d int32 tensor on the CPU, so the learning rate and
bias corrections are host numbers and reading them costs no device sync.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional

import torch

from repro_torch.models.model import map_tree, tree_paths


# Elements an update slice of a leaf with bf16 moments upcasts at once
# (64 MB of fp32 a moment).
UPDATE_SLICE = 1 << 24
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: OptimizerConfig, step: int) -> float:
    """Linear warmup + cosine decay at (1-based) ``step``."""
    step = float(step)
    if step < cfg.warmup_steps:
        return cfg.lr * step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    t = min(max((step - cfg.warmup_steps) / decay_steps, 0.0), 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + math.cos(math.pi * t))
    return cfg.lr * cos


def global_norm(grads: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the summed squares of every float gradient, as a 0-d fp32
    tensor on the gradients' device (one reduction per leaf, no temp)."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in grads if g is not None and g.is_floating_point()]
    return torch.stack(norms).square().sum().sqrt()


def adamw_init(params, optimizer_dtype: str = "float32") -> Dict[str, Any]:
    """Zero moments in ``optimizer_dtype`` ("float32" or "bfloat16") for
    every float leaf (integer tables keep their dtype), and step 0 on the
    CPU."""
    dtype = DTYPES[optimizer_dtype]

    def zeros(p):
        return torch.zeros_like(p, dtype=dtype if p.is_floating_point() else p.dtype)

    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, opt_state: Dict[str, Any],
                 grad_norm: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """One AdamW step IN PLACE on ``params`` (fp32), ``opt_state["m"]``,
    ``opt_state["v"]`` (fp32 or bf16) and ``opt_state["step"]``.  ``grads``
    has the params' tree (None for integer tables, which pass through) and
    is consumed: each fp32 gradient is overwritten as scratch.  ``grad_norm``
    may be passed when the caller has it already.  Returns {"grad_norm",
    "lr"}."""
    step = int(opt_state["step"]) + 1
    lr = lr_schedule(cfg, step)
    flat_g = tree_paths(grads)
    gnorm = global_norm(flat_g.values()) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    flat_m, flat_v = tree_paths(opt_state["m"]), tree_paths(opt_state["v"])
    for path, p in tree_paths(params).items():
        g = flat_g.get(path)
        if g is None or not p.is_floating_point():
            continue
        g = g.float().mul_(scale)
        m, v = flat_m[path], flat_v[path]
        # fp32 moments: the whole leaf in place; bf16: upcast slices.
        if m.dtype == torch.float32:
            parts = [(p, g, m, v)]
        else:
            flat = [t.view(-1) for t in (p, g, m, v)]
            parts = [[t[i:i + UPDATE_SLICE] for t in flat]
                     for i in range(0, p.numel(), UPDATE_SLICE)]
        for pc, gc, mc, vc in parts:
            m32, v32 = mc.float(), vc.float()  # the slices themselves when fp32
            m32.mul_(b1).add_(gc, alpha=1 - b1)
            v32.mul_(b2).addcmul_(gc, gc, value=1 - b2)
            den = torch.div(v32, bc2, out=gc).sqrt_().add_(cfg.eps)  # gc is scratch now
            # p - lr * (m/bc1 / den + wd * p), with p's old value in both terms
            pc.mul_(1 - lr * cfg.weight_decay).addcdiv_(m32, den, value=-lr / bc1)
            if m32 is not mc:
                mc.copy_(m32)
                vc.copy_(v32)
    opt_state["step"].add_(1)
    return {"grad_norm": gnorm, "lr": lr}
