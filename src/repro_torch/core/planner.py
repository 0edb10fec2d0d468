"""Parameter estimation (paper §5.1) — the ``Chain`` of a sequence of
PyTorch stage functions, two ways:

- **analytic** (:func:`profile_stages_analytic`): nothing runs on a device.
  Activation sizes come from one forward of each stage on ``meta`` tensors;
  times are the caller's per-stage FLOP counts over a peak rate the caller
  supplies (on the card, a measured one): the port carries no device
  constant.
- **measured** (:func:`profile_stages_measured`): each stage runs on real
  tensors, as the paper's tool runs it — forward and backward times and,
  on CUDA, the transient memory of each.

In both, the residual set ``ā`` of a stage is what autograd saves during
its forward, observed with ``torch.autograd.graph.saved_tensors_hooks``, so
the two give the same sizes for the same stages.  On CUDA the measured
sizes are what the caching allocator may hold for those tensors
(:func:`allocator_bytes`), which the analytic chain gives with
``allocator=True``.
:func:`measure_host_bandwidth` times the device↔host link that prices the
host tier.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..tree import tensors_of
from .chain import Chain, HostTransferModel


def measure_host_bandwidth(sample_bytes: int = 1 << 26, repeats: int = 20,
                           latency: float = 1e-4,
                           device=None) -> HostTransferModel:
    """The device↔host copy rate each way (paper §5.1: time the real
    operation).  On CUDA, a device buffer of ``sample_bytes`` is copied into
    pinned host memory and back with ``non_blocking=True``, each copy
    between two CUDA events, and each direction's rate is ``sample_bytes``
    over the median of ``repeats`` copies (after 3 more); elsewhere the
    copies are host memcpy on the host clock.  Runs on CUDA unless
    ``device`` names another device."""
    dev = resolve_device(device)
    src = torch.ones(max(int(sample_bytes), 1), dtype=torch.uint8,
                     device=dev)
    host = torch.empty(src.shape, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")

    def median_s(copy) -> float:
        for _ in range(3):
            copy()
        times = []
        for _ in range(repeats):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                copy()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e-3)
            else:
                t0 = time.perf_counter()
                copy()
                times.append(time.perf_counter() - t0)
        return max(statistics.median(times), 1e-12)

    nbytes = src.numel()
    d2h = median_s(lambda: host.copy_(src, non_blocking=True))
    h2d = median_s(lambda: src.copy_(host, non_blocking=True))
    return HostTransferModel(bandwidth_d2h=nbytes / d2h,
                             bandwidth_h2d=nbytes / h2d, latency=latency)


def _base(t: torch.Tensor) -> torch.Tensor:
    return t if t._base is None else t._base


def allocator_bytes(nbytes: int) -> int:
    """The most PyTorch's CUDA caching allocator (default settings) may hold
    for a storage of ``nbytes``: rounded up to 512 B, and above 1 MiB also
    the up to 1 MiB that a free block it serves the request from keeps
    unsplit.  The simulator counts each live tensor at this size, so that a
    plan's predicted peak bounds the allocator's."""
    rounded = -(-int(nbytes) // 512) * 512
    return rounded + (1 << 20) if rounded > (1 << 20) else rounded


def _sized(nbytes: Sequence[int], allocator: bool) -> int:
    return sum(allocator_bytes(n) if allocator else n for n in nbytes)


def _tree_size(tree: Any, allocator: bool) -> int:
    """``tree_bytes``, each tensor at :func:`allocator_bytes` with
    ``allocator``."""
    return _sized([t.numel() * t.element_size() for t in tensors_of(tree)],
                  allocator)


def _fresh_input(tree: Any, grad: bool = True) -> Any:
    """A copy of an activation whose floating tensors are new leaves that
    require grad (so autograd saves what the input gradient needs), or with
    ``grad=False`` detached leaves that do not (a chain input that needs no
    gradient)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            return tree.detach().requires_grad_(grad)
        return tree
    if isinstance(tree, dict):
        return {k: _fresh_input(v, grad) for k, v in tree.items()}
    return tree


class _Seed(torch.autograd.Function):
    """A scalar whose backward hands boxed cotangents to the outputs it was
    made from and keeps no reference to them.  A backward seeded through it
    frees each cotangent and each unsaved output as soon as autograd is done
    with them, as the chain's own backward does; passed as
    ``grad_outputs`` they would live to the call's end."""

    @staticmethod
    def forward(ctx, box, *outs):
        ctx.box = box
        return outs[0].new_zeros(())

    @staticmethod
    def backward(ctx, _):
        cots, ctx.box = ctx.box, None
        grads = tuple(cots)
        cots.clear()
        return (None, *grads)


def seeded(outs: List[torch.Tensor], cotangents: List[torch.Tensor]
           ) -> torch.Tensor:
    """The scalar to differentiate for the cotangents ``cotangents`` on
    ``outs`` (see :class:`_Seed`).  The two lists are emptied: the caller
    must drop every other reference to those tensors before the backward."""
    seed = _Seed.apply(list(cotangents), *outs)
    outs.clear()
    cotangents.clear()
    return seed


def residual_bytes(fn: Callable, p: Any, a: Any,
                   allocator: bool = False) -> Tuple[Any, int]:
    """``(fn(p, a), ω_ā)`` for one stage: the bytes of every storage autograd
    saves while running the stage, each counted once, leaving out the
    stage's own parameters and its input ``a^{l-1}`` (the paper removes
    model memory from the activation budget, and ``ā^l`` excludes
    ``a^{l-1}``).  Output tensors that were not saved are added, since
    ``ā^l`` includes ``a^l``.  With ``allocator``, each storage counts at
    :func:`allocator_bytes`."""
    excluded = {id(_base(t)) for t in tensors_of(p) + tensors_of(a)}
    saved: Dict[int, torch.Tensor] = {}

    def pack(t: torch.Tensor) -> torch.Tensor:
        b = _base(t)
        if id(b) not in excluded:
            saved[id(b)] = b
        # no backward runs through this graph; a saved output returned as
        # itself would hold its own grad_fn, a cycle through autograd's
        # C++ that the garbage collector cannot free
        return t.detach()

    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        out = fn(p, a)
    for t in tensors_of(out):
        b = _base(t)
        if id(b) not in excluded:
            saved.setdefault(id(b), b)
    nbytes = _sized([t.numel() * t.element_size() for t in saved.values()],
                    allocator)
    saved.clear()    # the graph keeps the hook, the hook these tensors
    return out, nbytes


def profile_stages_analytic(stages: Sequence[Callable], params: Sequence[Any],
                            x: Any, *, flops_fwd: Sequence[float],
                            flops_bwd: Sequence[float],
                            peak_flops: float,
                            host: Optional[HostTransferModel] = None,
                            allocator: bool = False) -> Chain:
    """Build the chain cost model from a forward on ``meta`` tensors:
    ``params`` and ``x`` should live on the meta device (parameters with
    ``requires_grad``).  ``uf``/``ub`` are ``flops / peak_flops`` seconds;
    ``host`` prices the host tier (a measured link, or ``None``); with
    ``allocator`` each tensor counts at :func:`allocator_bytes`, as the
    measured chain counts it on CUDA."""
    if peak_flops <= 0:
        raise ValueError("peak_flops must be positive")
    n = len(stages)
    wa, wabar = [_tree_size(x, allocator)], []
    a = x
    for i, (fn, p) in enumerate(zip(stages, params)):
        out, res = residual_bytes(fn, p, _fresh_input(a), allocator)
        wabar.append(res)
        if i < n - 1:
            wa.append(_tree_size(out, allocator))
        a = out
    return Chain.make(uf=[f / peak_flops for f in flops_fwd],
                      ub=[f / peak_flops for f in flops_bwd],
                      wa=wa, wabar=wabar, host=host)


def _grad_consumers(outputs: Sequence[torch.Tensor],
                    params: Sequence[torch.Tensor]) -> Dict[Any, list]:
    """The nodes of the graph behind ``outputs`` that return a gradient for
    one of ``params``: ``{node: [(output slot, index into params)]}``."""
    index = {id(p): i for i, p in enumerate(params)}
    found = {}
    seen = {o.grad_fn for o in outputs if o.grad_fn is not None}
    stack = list(seen)
    while stack:
        node = stack.pop()
        for slot, (nxt, _) in enumerate(node.next_functions):
            if nxt is None:
                continue
            var = getattr(nxt, "variable", None)
            if var is not None:
                if id(var) in index:
                    found.setdefault(node, []).append((slot, index[id(var)]))
            elif nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return found


def grad_with_peaks(outputs: Sequence[torch.Tensor],
                    inputs: Sequence[torch.Tensor],
                    grad_outputs: Optional[Sequence[torch.Tensor]] = None,
                    params: Sequence[torch.Tensor] = (),
                    allow_unused: bool = False) -> tuple:
    """``torch.autograd.grad(outputs, inputs, grad_outputs,
    allow_unused=allow_unused)`` with, on CUDA, two readings of the
    allocator over the span since its peak counter was last reset:
    ``(grads, peak, activation_peak)``.  ``peak`` is its peak;
    ``activation_peak`` the peak of the bytes allocated less the gradients
    of ``params`` formed by then, which the activation budget leaves out.
    A parameter's gradient counts as formed once the first node that
    returns a share of it has returned (later shares are summed into it):
    the peak of each span between two such nodes is read and the counter
    reset, so a gradient weighs on the span in which it was made and is
    left out after it.  A gradient not yet made at the peak is not
    subtracted.  Off CUDA both readings are ``None``."""
    dev = outputs[0].device
    if dev.type != "cuda":
        return (torch.autograd.grad(outputs, inputs, grad_outputs,
                                    allow_unused=allow_unused), None, None)
    sizes = [p.numel() * p.element_size() for p in params]
    formed, state = set(), {"grads": 0, "peak": 0, "act": 0}

    def close_span():
        peak = torch.cuda.max_memory_allocated(dev)
        state["peak"] = max(state["peak"], peak)
        state["act"] = max(state["act"], peak - state["grads"])

    def hook_for(slots):
        def hook(grad_inputs, _grad_outputs):
            close_span()
            for slot, i in slots:
                if grad_inputs[slot] is not None and i not in formed:
                    formed.add(i)
                    state["grads"] += sizes[i]
            torch.cuda.reset_peak_memory_stats(dev)
        return hook

    handles = [node.register_hook(hook_for(slots)) for node, slots
               in _grad_consumers(outputs, params).items()]
    try:
        grads = torch.autograd.grad(outputs, inputs, grad_outputs,
                                    allow_unused=allow_unused)
    finally:
        for h in handles:
            h.remove()
    close_span()
    return grads, state["peak"], state["act"]


def _stage_pass(fn: Callable, p: Any, a: Any, dev: torch.device,
                input_grad: bool = True) -> tuple:
    """One forward under grad and one backward of a stage on real tensors:
    ``(forward s, backward s, forward transient B, backward transient B)``.

    Times are CUDA-event pairs on CUDA (the host clock elsewhere).  On CUDA
    the peak allocator count is reset before each op: the forward's
    transient is its peak less the memory after it (the memory before it
    plus what it leaves live: output and saved tensors); the backward's is
    its peak less the memory before it (``ā``, ``δ`` and the input live),
    the parameter gradients formed by then left out
    (:func:`grad_with_peaks`).  The backward runs in the chain's liveness:
    seeded through :func:`seeded`, so the cotangent and an output the stage
    did not save die when autograd is done with them, and without the
    input's gradient where the chain's input needs none
    (``input_grad=False``).  Off CUDA both transients are 0."""
    cuda = dev.type == "cuda"
    inp = _fresh_input(a, input_grad)
    if cuda:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.reset_peak_memory_stats(dev)
        ev[0].record()
    else:
        t0 = time.perf_counter()
    with torch.enable_grad():
        out = fn(p, inp)
    if cuda:
        ev[1].record()
        f_transient = (torch.cuda.max_memory_allocated(dev)
                       - torch.cuda.memory_allocated(dev))
    else:
        t1 = time.perf_counter()
    outs = [o for o in tensors_of(out)
            if o.is_floating_point() and o.requires_grad]
    if not outs:    # no parameter and no input gradient: no backward runs
        if cuda:
            ev[1].synchronize()
            return (ev[0].elapsed_time(ev[1]) * 1e-3, 0.0,
                    max(f_transient, 0), 0)
        return t1 - t0, 0.0, 0, 0
    ins = [t for t in tensors_of(inp)
           if t.is_floating_point() and t.requires_grad]
    ps = tensors_of(p)
    seed = seeded(outs, [torch.ones_like(o) for o in outs])
    one = torch.ones_like(seed)     # allocated before the count starts
    del out
    if cuda:
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ev[2].record()
    else:
        t2 = time.perf_counter()
    _, _, act_peak = grad_with_peaks([seed], ins + ps, [one], ps,
                                     allow_unused=True)
    if not cuda:
        return t1 - t0, time.perf_counter() - t2, 0, 0
    ev[3].record()
    b_transient = act_peak - before
    ev[3].synchronize()
    return (ev[0].elapsed_time(ev[1]) * 1e-3, ev[2].elapsed_time(ev[3]) * 1e-3,
            max(f_transient, 0), max(b_transient, 0))


def chain_backward_transients(stages: Sequence[Callable],
                              params: Sequence[Any], x: Any) -> List[int]:
    """Each stage's backward transient *inside* the chain (CUDA only), as
    :func:`_stage_pass` reads it in isolation: the whole chain's forward
    under grad, then one backward (the parameters' gradients, and the
    input's where it requires grad) in which a hook on each stage's output
    marks where that stage's backward starts, its gradient formed.  A
    stage's transient is its backward's activation peak (the allocator's
    peak less the parameter gradients made by then, read as
    :func:`grad_with_peaks` reads it) less the memory at its mark.  Entry
    ``l-1`` is paper stage ``l``: what the isolated ``ob`` stands for."""
    leaves = tensors_of([list(params), x])
    dev = leaves[0].device
    if dev.type != "cuda":
        raise ValueError("chain_backward_transients reads the CUDA "
                         "allocator")
    n = len(stages)
    got = [0] * n
    ps = [t for t in tensors_of(list(params)) if t.requires_grad]
    sizes = [t.numel() * t.element_size() for t in ps]
    formed: set = set()
    st = {"stage": n, "start": 0, "act": 0, "grads": 0}

    def close_span() -> None:
        st["act"] = max(st["act"], torch.cuda.max_memory_allocated(dev)
                        - st["grads"])

    def mark(i: int) -> None:
        if i >= st["stage"]:
            return                    # another output of a marked stage
        close_span()
        if st["stage"] < n:
            got[st["stage"]] = st["act"] - st["start"]
        st["stage"] = i
        st["start"] = st["act"] = (torch.cuda.memory_allocated(dev)
                                   - st["grads"])
        torch.cuda.reset_peak_memory_stats(dev)

    def hook_outputs(out: Any, i: int) -> None:
        # a function, so that no loop variable keeps an output alive
        for t in tensors_of(out):
            if t.is_floating_point() and t.requires_grad:
                t.register_hook(lambda g: mark(i))

    a = x
    with torch.enable_grad():
        for i, (fn, p) in enumerate(zip(stages, params)):
            a = fn(p, a)
            if i < n - 1:
                hook_outputs(a, i)

    def hook_for(slots):
        def hook(grad_inputs, _grad_outputs):
            close_span()
            for slot, k in slots:
                if grad_inputs[slot] is not None and k not in formed:
                    formed.add(k)
                    st["grads"] += sizes[k]
            torch.cuda.reset_peak_memory_stats(dev)
        return hook

    handles = [node.register_hook(hook_for(slots)) for node, slots
               in _grad_consumers([a], ps).items()]
    wrt = ps + [t for t in tensors_of(x) if t.requires_grad]
    mark(n - 1)
    try:
        grads = torch.autograd.grad(a, wrt, allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    mark(-1)
    del grads, a
    return got


def profile_stages_measured(stages: Sequence[Callable],
                            params: Sequence[Any], x: Any, repeats: int = 3,
                            host: Optional[HostTransferModel] = None
                            ) -> Chain:
    """Measure the chain on real tensors (the paper's §5.1 measurement
    phase), on the device ``params`` and ``x`` live on.

    - ``wa``/``wabar``: as :func:`profile_stages_analytic` counts them (the
      same saved-tensor hook), so the two chains agree on sizes; on CUDA
      each tensor at :func:`allocator_bytes` (the analytic chain's
      ``allocator=True``): the allocator's rounding of the tensors a plan
      keeps is memory the card holds.
    - ``uf``/``ub``: after one pass that pays the kernel builds and cuBLAS
      workspaces, the median of ``repeats`` timings of the forward under
      grad and of the backward alone — CUDA events on CUDA, the host clock
      elsewhere.  The JAX package times forward+backward and takes ``ub``
      as the difference, floored at ``uf / 4``, which on a host clock can
      come out negative; timing the backward by itself needs no floor.
    - ``of``/``ob``: the transient memory of each stage's forward and
      backward, from the CUDA allocator's peak counter (see
      :func:`_stage_pass`; the largest over the repeats).  Off CUDA they
      are 0, as in the JAX package, whose measured profile has no per-op
      peak either.
    """
    leaves = tensors_of([list(params), x])
    dev = leaves[0].device if leaves else torch.device("cpu")
    n = len(stages)
    alloc = dev.type == "cuda"
    uf, ub, of, ob = [], [], [], []
    wa, wabar = [_tree_size(x, alloc)], []
    a = x
    for i, (fn, p) in enumerate(zip(stages, params)):
        out, res = residual_bytes(fn, p, _fresh_input(a), alloc)
        del out
        wabar.append(res)
        # the chain's first input needs a gradient only if it requires one
        grad_in = i > 0 or any(t.requires_grad for t in tensors_of(x))
        _stage_pass(fn, p, a, dev, grad_in)
        runs = [_stage_pass(fn, p, a, dev, grad_in) for _ in range(repeats)]
        uf.append(statistics.median(r[0] for r in runs))
        ub.append(statistics.median(r[1] for r in runs))
        of.append(max(r[2] for r in runs))
        ob.append(max(r[3] for r in runs))
        if i < n - 1:
            with torch.no_grad():
                a = fn(p, a)
            wa.append(_tree_size(a, alloc))
    return Chain.make(uf=uf, ub=ub, wa=wa, wabar=wabar, of=of, ob=ob,
                      host=host)
