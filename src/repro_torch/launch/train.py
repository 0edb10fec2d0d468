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

``--ckpt-dir DIR`` checkpoints parameters, moments and the plan into
``DIR`` after every ``--ckpt-every`` steps (default 25) and at the end,
and a run started on a directory that holds a checkpoint resumes at the
step after it (the data and learning rate are functions of the step).

Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) every rank joins one
process group and the run is sharded (ZeRO-3, see
:mod:`repro_torch.distributed.sharding`) over a ``(data, model)`` mesh that
:func:`~repro_torch.distributed.fault_tolerance.elastic_plan` sizes from
the world size, ``--model-parallel`` and the global batch::

    torchrun --nproc-per-node 1 -m repro_torch.launch.train --arch ...

``--dist-backend auto`` takes NCCL on CUDA with one card per rank and gloo
on the CPU or when ranks share a card (NCCL refuses two ranks on one
device: asking for it there raises).  Each rank runs on
``cuda:LOCAL_RANK`` modulo the cards it sees.  Rank 0 alone logs and
writes checkpoints; a checkpoint written at one world size resumes at
another.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Tuple

import torch

from .. import counters
from ..configs import get_config, smoke_config
from ..device import rank_device
from ..models.lm import ModelConfig
from ..runtime.train_loop import TrainLoopConfig, run_training


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
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
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint into this directory and resume from "
                         "its newest checkpoint")
    ap.add_argument("--ckpt-every", type=int, default=25,
                    help="save after every this many steps (0: only at "
                         "the end; default: %(default)s)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="width of the mesh's model axis under torchrun "
                         "(default: %(default)s)")
    ap.add_argument("--dist-backend", default="auto",
                    choices=("auto", "nccl", "gloo"),
                    help="process-group backend under torchrun: auto takes "
                         "NCCL on CUDA with a card per rank, gloo on the CPU "
                         "or when ranks share a card")
    ap.add_argument("--data-hosts-per-process", type=int, default=1,
                    help="consecutive host slices of the global batch each "
                         "process reads (a run resumed on fewer processes "
                         "keeps the global batch of the run that wrote its "
                         "checkpoint)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--override", default=None, help="JSON config overrides")
    return ap


def parse(argv=None) -> Tuple[ModelConfig, TrainLoopConfig, str]:
    """The launcher's flags → (model config, loop config, device)."""
    return _configs(_parser().parse_args(argv))


def _configs(args) -> Tuple[ModelConfig, TrainLoopConfig, str]:
    ov = {k: tuple(v) if isinstance(v, list) else v  # e.g. layer_kinds
          for k, v in json.loads(args.override or "{}").items()}
    cfg = (smoke_config(args.arch, **ov) if args.smoke
           else get_config(args.arch, **ov))
    loop = TrainLoopConfig(steps=args.steps, global_batch=args.global_batch,
                           seq_len=args.seq_len, lr=args.lr,
                           policy=args.policy, num_slots=args.num_slots,
                           solver_impl=args.solver_impl,
                           peak_flops=args.peak_flops, log_every=1,
                           ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every,
                           data_hosts_per_process=args.data_hosts_per_process)
    return cfg, loop, args.device


def backend_for(device: str, requested: str, local_world: int,
                n_cards: int) -> str:
    """The process-group backend: gloo on the CPU; on CUDA, NCCL when every
    local rank has a card of its own, gloo when ranks share one (``auto``);
    NCCL asked for on shared cards raises ``ValueError``."""
    if torch.device(device).type != "cuda":
        if requested == "nccl":
            raise ValueError("NCCL runs on CUDA devices only; use gloo on "
                             "the CPU")
        return "gloo"
    shared = local_world > n_cards
    if requested == "nccl" and shared:
        raise ValueError(
            f"NCCL refuses two ranks on one device: {local_world} local "
            f"ranks on {n_cards} card(s); pass --dist-backend gloo to share "
            f"a card, or give every rank its own")
    if requested == "auto":
        return "gloo" if shared else "nccl"
    return requested


def _init_mesh(args, loop: TrainLoopConfig):
    """Under torchrun: join the process group and build the run's mesh;
    returns ``(device, mesh, rank)``."""
    import torch.distributed as dist

    from ..distributed.fault_tolerance import elastic_plan
    from ..distributed.sharding import make_mesh

    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device = args.device
    cuda = torch.device(device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass --device cpu to run on the CPU")
        n_cards = torch.cuda.device_count()
        backend = backend_for(device, args.dist_backend, local_world,
                              n_cards)
        device = rank_device(device, local_rank)
        torch.cuda.set_device(device)
    else:
        backend = backend_for(device, args.dist_backend, local_world, 0)
    (data, model), _, _ = elastic_plan(world, args.model_parallel,
                                       loop.global_batch)
    if data * model != world:
        raise ValueError(f"{world} ranks do not fill a ({data}, {model}) "
                         f"mesh for global batch {loop.global_batch}")
    dist.init_process_group(backend, rank=rank, world_size=world)
    mesh = make_mesh((data, model), "cuda" if cuda else "cpu")
    if rank == 0:
        print(f"[train] mesh data={data} model={model} over {world} ranks "
              f"({backend})", flush=True)
    return device, mesh, rank


def main(argv=None) -> Dict[str, Any]:
    """Parse ``argv``, train, print a summary; returns the run's result
    (see :func:`repro_torch.runtime.train_loop.run_training`)."""
    args = _parser().parse_args(argv)
    cfg, loop, device = _configs(args)
    mesh, rank = None, 0
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        device, mesh, rank = _init_mesh(args, loop)
    say = (lambda s: print(s, flush=True)) if rank == 0 else (lambda s: None)
    say(f"[train] arch={cfg.name} layers={cfg.num_layers} "
        f"chunks={len(cfg.chunks)} device={device}")
    try:
        out = run_training(cfg, loop, device=device, log_fn=say, mesh=mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
    say(f"[train] done: {len(out['losses'])} steps, "
        f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, "
        f"{out['tokens_per_s']:.0f} tok/s")
    say("[train] result " + json.dumps({
        "losses": out["losses"],
        "grad_norms": [r["grad_norm"] for r in out["steps"]],
        "step_seconds": [r["seconds"] for r in out["steps"]],
        "plan_digest": out["plan_digest"],
        "param_bytes_local": out["param_bytes_local"],
        "collective_bytes": out["collective_bytes"],
        "data_slices": out["data_slices"], "launches": counters.snapshot()}))
    return out


if __name__ == "__main__":
    main()
