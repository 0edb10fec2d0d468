"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs on one CUDA device unless ``--device cpu`` is given.  On CUDA the plan
is solved on the chain measured on the model's weights and the first batch
(the paper's §5.1 measurement); on the CPU on the analytic chain, whose
stage times are FLOPs over ``--peak-flops``.  Example (the full-width
Qwen1.5-4B cut to 8 layers, under a rotor plan solved on the CUDA band-min
kernel)::

    python -m repro_torch.launch.train --arch qwen1.5-4b \\
        --override '{"num_layers": 8, "layer_kinds": ["dense", "dense",
                     "dense", "dense", "dense", "dense", "dense", "dense"],
                     "n_chunks": 8, "use_flash_attention": true}' \\
        --global-batch 4 --seq-len 2048 --steps 3 \\
        --policy rotor:x0.5 --solver-impl cuda

and on the CPU at the smoke width::

    python -m repro_torch.launch.train --arch qwen1.5-4b --smoke \\
        --device cpu --global-batch 2 --seq-len 32 --steps 3 \\
        --policy rotor:x0.7 --peak-flops 1e12

``--policy optimal_offload:BUDGET:BW`` plans three tiers (device, host,
recompute) with a host link of ``BW`` bytes/s (measure it on the card) and
trains on the eager offload walker when the plan offloads anything.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Tuple

from ..configs import get_config, smoke_config
from ..models.lm import ModelConfig
from ..runtime.train_loop import TrainLoopConfig, run_training


def parse(argv=None) -> Tuple[ModelConfig, TrainLoopConfig, str]:
    """The launcher's flags → (model config, loop config, device)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--policy", default=None,
                    help="remat policy: none|full|periodic:K|rotor:BUDGET|"
                         "revolve:BUDGET|optimal_offload:BUDGET:BW (BUDGET: "
                         "bytes like "
                         "800M, x0.6 of the store-all peak, or auto; BW: the "
                         "measured host link in bytes/s, 0 for two tiers)")
    ap.add_argument("--num-slots", type=int, default=None,
                    help="DP discretization slots (default: plan default)")
    ap.add_argument("--solver-impl", default=None,
                    choices=("banded", "plain", "cuda", "cuda_fused"),
                    help="DP fill: numpy, plain PyTorch on the CPU, the "
                         "CUDA band-min kernels (one launch per band), or "
                         "the whole fill on the card (default: banded)")
    ap.add_argument("--peak-flops", type=float, default=None,
                    help="FLOP/s that price the analytic chain's stages: "
                         "needed off CUDA by every policy but none (on CUDA "
                         "the plan is solved on the measured chain)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--override", default=None, help="JSON config overrides")
    args = ap.parse_args(argv)

    ov = {k: tuple(v) if isinstance(v, list) else v  # e.g. layer_kinds
          for k, v in json.loads(args.override or "{}").items()}
    cfg = (smoke_config(args.arch, **ov) if args.smoke
           else get_config(args.arch, **ov))
    loop = TrainLoopConfig(steps=args.steps, global_batch=args.global_batch,
                           seq_len=args.seq_len, lr=args.lr,
                           policy=args.policy, num_slots=args.num_slots,
                           solver_impl=args.solver_impl,
                           peak_flops=args.peak_flops, log_every=1)
    return cfg, loop, args.device


def main(argv=None) -> Dict[str, Any]:
    """Parse ``argv``, train, print a summary; returns the run's result
    (see :func:`repro_torch.runtime.train_loop.run_training`)."""
    cfg, loop, device = parse(argv)
    print(f"[train] arch={cfg.name} layers={cfg.num_layers} "
          f"chunks={len(cfg.chunks)} device={device}", flush=True)
    out = run_training(cfg, loop, device=device,
                       log_fn=lambda s: print(s, flush=True))
    print(f"[train] done: {len(out['losses'])} steps, "
          f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, "
          f"{out['tokens_per_s']:.0f} tok/s", flush=True)
    return out


if __name__ == "__main__":
    main()
