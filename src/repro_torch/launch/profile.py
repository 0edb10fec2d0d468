"""Where one training step's device time goes:
``python -m repro_torch.launch.profile --arch <id> [...]``.

Takes the flags of :mod:`.train` and trains as it does, ``--steps`` steps
of warm-up, then runs one more step under ``torch.profiler`` (CPU and CUDA
activities) and prints, beside that step's wall time:

- the summed device time of every kernel, grouped into the port's own
  kernels (by wrapper name), cuBLAS matrix products and PyTorch's other
  kernels, with the busy share (summed kernel time over wall time);
- the device time under the backward of each of the port's autograd
  functions (the plain recomputes);
- the device time under each program span (``step.forward``,
  ``step.backward``, ``step.optimizer``, ``remat.forward``,
  ``remat.replay``, ``remat.backward``: :mod:`repro_torch.obs.trace`);
- the kernels that take the most device time;
- the step's longest idle gaps on the device, each put down to the
  innermost program span open on the host when the device went idle (the
  span's range in the same profiler trace, on the profiler's clock).

It runs on CUDA only: a profile of the CPU says nothing about the card.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType

from ..data.pipeline import SyntheticLMData
from ..device import resolve_device
from ..models.lm import StagedLM
from ..obs.trace import PROGRAM_SPANS
from ..optim.adamw import AdamWConfig
from ..runtime.train_loop import run_training
from . import train
from .steps import make_offload_step, make_train_step

# kernel-name fragments of the port's own kernels, by wrapper name (K3, K6:
# the bf16 tensor-core kernel and the scalar one)
PORT_KERNELS = {"ssd_chunk": ("ssd_chunk_mma", "ssd_chunk_kernel"),
                "flash_attention_fwd": ("flash_fwd_sm90", "flash_fwd_kernel"),
                "rms_norm": ("rms_norm_kernel",)}
MATMUL = ("gemm", "nvjet", "xmma", "cutlass", "splitKreduce")
AUTOGRAD_FUNCTIONS = ("_SSDChunkedBackward", "_FlashAttentionBackward",
                      "_RMSNormBackward")
TOP = 15


def _group(name: str) -> str:
    for wrapper, fragments in PORT_KERNELS.items():
        if any(f in name for f in fragments):
            return wrapper
    if any(m in name for m in MATMUL):
        return "cuBLAS matmul"
    return "other PyTorch kernels"


def idle_gaps(device: Sequence[Tuple[float, float]],
              spans: Sequence[Tuple[str, float, float]], top: int = TOP
              ) -> List[Tuple[float, float, Optional[str]]]:
    """The ``top`` longest gaps between the device's operations
    (``(start, end)`` pairs), longest first, as ``(length, start, span)``:
    ``span`` is the innermost of ``spans`` (``(name, start, end)`` host
    ranges on the same clock) open when the device went idle, the latest
    opened of those that hold that moment; ``None`` where none does."""
    busy: List[List[float]] = []
    for s, e in sorted(device):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    gaps = []
    for (_, idle), (nxt, _) in zip(busy, busy[1:]):
        open_then = [(s, -(e - s), name) for name, s, e in spans
                     if s <= idle < e]
        gaps.append((nxt - idle, idle,
                     max(open_then)[2] if open_then else None))
    return sorted(gaps, key=lambda g: -g[0])[:top]


def main(argv=None) -> Dict[str, Any]:
    """Parse ``argv`` (the launcher's flags), warm up, profile one step and
    print the breakdown; returns it."""
    cfg, loop, device = train.parse(argv)
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the profile runs on CUDA, not {dev}")
    out = run_training(cfg, loop, device=dev,
                       log_fn=lambda s: print(s, flush=True))
    model, plan = StagedLM(cfg), out["plan"]
    if plan is not None and plan.uses_offload:
        step_fn = make_offload_step(model, AdamWConfig(lr=loop.lr),
                                    plan.schedule)
    else:
        step_fn = make_train_step(model, AdamWConfig(lr=loop.lr),
                                  plan.tree if plan is not None else None)
    batch = SyntheticLMData(cfg, loop.global_batch, loop.seq_len,
                            seed=loop.seed).device_batch(loop.steps, dev)
    torch.cuda.synchronize(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        float(step_fn(out["params"], out["opt_state"], batch,
                      loop.steps)["loss"])
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key not in PROGRAM_SPANS]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    groups: Dict[str, Dict[str, float]] = {}
    for e in kernels:
        g = groups.setdefault(_group(e.key), {"ms": 0.0, "launches": 0})
        g["ms"] += e.device_time_total / 1e3
        g["launches"] += e.count
    busy_ms = sum(g["ms"] for g in groups.values())
    backward = {e.key: e.device_time_total / 1e3 for e in events
                if e.key in AUTOGRAD_FUNCTIONS}
    under = {e.key: e.device_time_total / 1e3 for e in events
             if e.key in PROGRAM_SPANS and e.device_type != DeviceType.CUDA}
    # a host range also shows on the device's timeline as an annotation
    raw = prof.events()
    ranges = {e.name for e in raw if e.device_type != DeviceType.CUDA}
    gaps = idle_gaps(
        [(e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in raw
         if e.device_type == DeviceType.CUDA and e.name not in ranges],
        [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
         for e in raw if e.device_type != DeviceType.CUDA
         and e.name in PROGRAM_SPANS])
    card = torch.cuda.get_device_name(dev)
    print(f"[profile] {cfg.name} {cfg.num_layers} layers, batch "
          f"{loop.global_batch} x {loop.seq_len}, policy {loop.policy}: one "
          f"step {wall_ms:.3f} ms wall, kernels {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f} % busy) on {card}")
    for name, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"[profile] {name}: {g['ms']:.3f} ms in {g['launches']} "
              f"launches ({100 * g['ms'] / wall_ms:.1f} % of the step)")
    for key, ms in backward.items():
        print(f"[profile] under {key}: {ms:.3f} ms of device time "
              f"({100 * ms / wall_ms:.1f} % of the step)")
    for key in PROGRAM_SPANS:
        if key in under:
            print(f"[profile] under span {key}: {under[key]:.3f} ms of "
                  f"device time ({100 * under[key] / busy_ms:.1f} % of the "
                  f"kernels')")
    for gap, at, name in gaps:
        print(f"[profile] idle {gap * 1e3:.3f} ms from {at:.6f} s, the host "
              f"in {name or 'no program span'}")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:TOP]:
        print(f"[profile] kernel {e.device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "groups": groups,
            "backward_ms": backward, "under_ms": under, "idle_gaps": gaps,
            "device": card}


if __name__ == "__main__":
    main()
