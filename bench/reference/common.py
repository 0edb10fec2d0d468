"""What the plain references share: the weight maker, float32 (and the
control's fp8) matrix products, RMSNorm, AdamW, and the driver that
follows the first training steps.

Plain PyTorch, float32, TF32 off; nothing of the program is imported.  The
weights are made here from the run's seed, in the tree layout the program
takes (dicts and lists of tensors, each chunk's layers stacked along a
leading axis) and in the dtypes the configuration stores them in; the
benchmark hands the same tree to the program and, cast to float32, to the
reference.

The control (``precision="fp8"``) is the same reference with every matrix
product's operands, and its gradient's, rounded to float8 e4m3 under a
per-tensor scale: the precision below the bfloat16 the configurations
state.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from bench.seeds import derive

PRECISIONS = ("float32", "fp8")
FP8_MAX = 448.0                   # largest finite float8 e4m3 value


# -- the weights -----------------------------------------------------------

def leaves(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every tensor leaf in insertion order (the
    order the program's optimizer lists them in)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else ())
    out = []
    for k, v in items:
        out.extend(leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def rebuild(tree: Any, values: Sequence[torch.Tensor]) -> Any:
    """``tree``'s structure with its tensor leaves replaced by ``values``
    (in :func:`leaves` order)."""
    it = iter(values)

    def go(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        return [go(v) for v in t]

    return go(tree)


def make_tree(spec: Any, seed: int, device) -> Any:
    """The weights that ``spec`` describes (the same nest, each leaf a
    ``(shape, dtype, init)`` with ``init`` ``("normal", std)``,
    ``("ones",)``, ``("zeros",)`` or ``("fn", f)``, ``f(generator,
    device)`` giving a float32 tensor), made on ``device`` from ``seed``:
    one standard-normal draw for all the leaves of a dtype, which the
    leaves then share as views (each scaled or filled in place), so a
    model's weights take a few large calls.  Leaves require grad."""
    specs = _spec_leaves(spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights"))
    align = 64
    offsets, totals = [], {}
    for shape, dtype, _ in specs:
        n = math.prod(shape)
        at = totals.get(dtype, 0)
        offsets.append(at)
        totals[dtype] = at + -(-n // align) * align
    buffers = {dtype: torch.randn(total, generator=gen, dtype=dtype,
                                  device=device)
               for dtype, total in totals.items()}
    out = []
    with torch.no_grad():
        for (shape, dtype, init), at in zip(specs, offsets):
            t = buffers[dtype][at:at + math.prod(shape)].view(shape)
            if init[0] == "normal":
                t.mul_(init[1])
            elif init[0] == "ones":
                t.fill_(1.0)
            elif init[0] == "zeros":
                t.zero_()
            else:
                t.copy_(init[1](gen, device).reshape(shape))
            out.append(t.detach().requires_grad_())
    return rebuild(_as_tree(spec), out)


def _is_leaf_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[2], tuple)


def _spec_leaves(spec) -> list:
    if _is_leaf_spec(spec):
        return [spec]
    items = spec.values() if isinstance(spec, dict) else spec
    return [leaf for v in items for leaf in _spec_leaves(v)]


def _as_tree(spec):
    """``spec`` with a placeholder tensor per leaf (for :func:`rebuild`)."""
    if _is_leaf_spec(spec):
        return torch.empty(0)
    if isinstance(spec, dict):
        return {k: _as_tree(v) for k, v in spec.items()}
    return [_as_tree(v) for v in spec]


# -- products and norms ----------------------------------------------------

@contextlib.contextmanager
def full_float32():
    """Float32 products in float32: TF32 off for matmuls and convolutions
    while in the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude at e4m3's largest value), returned in float32."""
    scale = FP8_MAX / t.detach().abs().amax().clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with both operands, and in the backward the incoming
    gradient, rounded to fp8 first; ``a`` and ``b`` 2-D, or with the same
    leading dimensions."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = to_fp8(a), to_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = to_fp8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def matmul(precision: str) -> Callable:
    """``mm(a, b)``: the product as ``precision`` computes it."""
    if precision == "float32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")


def dense(mm: Callable, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., in) times w (in, *out) → (..., *out)."""
    out = w.shape[1:]
    y = mm(x.reshape(-1, w.shape[0]), w.reshape(w.shape[0], -1))
    return y.reshape(*x.shape[:-1], *out)


def layer_at(stage: Any, j: int) -> Any:
    """Layer ``j`` of a stage whose leaves stack its layers on axis 0."""
    if isinstance(stage, dict):
        return {k: layer_at(v, j) for k, v in stage.items()}
    return stage[j]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def token_loss(mm: Callable, h: torch.Tensor, scale: torch.Tensor,
               w: torch.Tensor, labels: torch.Tensor, eps: float,
               block: int = 2048) -> torch.Tensor:
    """Mean next-token cross-entropy of the final norm and the head over
    every position, in blocks of ``block`` tokens (each recomputed in the
    backward, so one block's logits are live at a time)."""
    d = h.shape[-1]
    h2, lab = h.reshape(-1, d), labels.reshape(-1).long()

    def part(hb, s, wk, lb):
        logits = mm(rms_norm(hb, s, eps), wk)
        return torch.nn.functional.cross_entropy(logits, lb, reduction="sum")

    total = sum(checkpoint(
        part, h2[i:i + block], scale, w, lab[i:i + block],
        use_reentrant=False) for i in range(0, h2.shape[0], block))
    return total / h2.shape[0]


# -- AdamW and the steps ---------------------------------------------------

ADAMW = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
             clip_norm=1.0)


def diff_norms(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor],
               device) -> List[float]:
    """``‖a_i − b_i‖`` of each pair of leaves, taken on ``device``."""
    with torch.no_grad():
        return [float(torch.linalg.vector_norm(
            x.to(device, torch.float32) - y.to(device, torch.float32)))
            for x, y in zip(a, b)]


def follow_steps(loss_fn: Callable, tree: Any, batches: Sequence[Dict],
                 precision: str = "float32", hp: Dict = ADAMW,
                 against: Optional[Sequence[torch.Tensor]] = None,
                 keep_first: bool = False) -> Dict:
    """Train a float32 copy of ``tree`` (the weights as made, in their
    stored dtypes, on the host or on the batches' device) on the batches'
    device for ``len(batches)`` steps of ``loss_fn(tree, batch, mm)`` and
    AdamW: global-norm clipping, bias-corrected moments, decay on the
    leaves of two or more dimensions (as laid out), each updated parameter
    rounded to its stored dtype, as the configuration stores it.  Returns
    each step's loss, each leaf's first (clipped) gradient norm and its
    change over the steps, by :func:`leaves` path; with ``against``
    (another run's first gradients, one tensor a leaf) also the norm of
    each leaf's difference from it (``grad_diff_norms``), and with
    ``keep_first`` the first gradients themselves, on the host
    (``first_grads``).  The first gradients are taken leaf by leaf, so
    that no second copy of them is ever whole on the device."""
    named = leaves(tree)
    device = next(iter(batches[0].values())).device
    stored = [t.detach() for _, t in named]
    params = [t.to(device, torch.float32).clone().requires_grad_()
              for t in stored]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    mm = matmul(precision)
    losses, first, out = [], None, {}
    with full_float32():
        for count, batch in enumerate(batches, start=1):
            loss = loss_fn(rebuild(tree, params), batch, mm)
            grads = torch.autograd.grad(loss, params)
            losses.append(float(loss.detach()))
            del loss
            with torch.no_grad():
                gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                clip = torch.clamp(hp["clip_norm"] / gnorm.clamp(min=1e-12),
                                   max=1.0)
                bc1 = 1.0 - hp["b1"] ** count
                bc2 = 1.0 - hp["b2"] ** count
                if first is None:
                    first, diffs, kept = [], [], []
                    for i, g in enumerate(grads):
                        c = g * clip
                        first.append(float(torch.linalg.vector_norm(c)))
                        if against is not None:
                            diffs.append(float(torch.linalg.vector_norm(
                                c - against[i].to(device, torch.float32))))
                        if keep_first:
                            kept.append(c.cpu())
                        del c
                    if against is not None:
                        out["grad_diff_norms"] = diffs
                    if keep_first:
                        out["first_grads"] = kept
                for p, g, m, v, s in zip(params, grads, mu, nu, stored):
                    g = g * clip
                    m.mul_(hp["b1"]).add_((1 - hp["b1"]) * g)
                    v.mul_(hp["b2"]).add_((1 - hp["b2"]) * g * g)
                    step = (m / bc1) / (torch.sqrt(v / bc2) + hp["eps"])
                    if hp["weight_decay"] and p.ndim >= 2:
                        step.add_(hp["weight_decay"] * p)
                    p.copy_((p - hp["lr"] * step).to(s.dtype).float())
            del grads
        change = [float(torch.linalg.vector_norm(
            p.detach() - s.to(device, torch.float32)))
            for p, s in zip(params, stored)]
    return {"paths": [path for path, _ in named], "losses": losses,
            "grad_norms": first, "change_norms": change, **out}
