"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``:
prefill a batch of random prompts (from a numpy seed) and greedy-decode,
on one CUDA device unless ``--device cpu`` is given.  On the card, e.g. the
full-width Qwen1.5-4B::

    python -m repro_torch.launch.serve --arch qwen1.5-4b --batch 8 \\
        --prompt-len 2048 --max-new-tokens 64 \\
        --override '{"use_flash_attention": true}'

and on the CPU at the smoke width::

    python -m repro_torch.launch.serve --arch qwen1.5-4b --smoke --device cpu

A VLM is served text-only (PaliGemma's Gemma decoder, its embedding scale
kept, without an image prefix) and an audio arch is skipped, as the JAX
package's launcher does; both run their prefix or frames at model level
(``StagedLM.prefill`` / ``decode_step``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, Optional

import numpy as np

from ..configs import get_config, smoke_config
from ..models.lm import StagedLM
from ..runtime.serve_loop import ServeLoopConfig, run_serving


def main(argv=None) -> Optional[Dict[str, Any]]:
    """Parse ``argv``, serve, print prefill ms, decode tokens/s and a
    sample generation; returns the run's result
    (:func:`repro_torch.runtime.serve_loop.run_serving`), ``None`` for an
    audio arch."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-servable)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--override", default=None, help="JSON config overrides")
    args = ap.parse_args(argv)

    ov = {k: tuple(v) if isinstance(v, list) else v  # e.g. layer_kinds
          for k, v in json.loads(args.override or "{}").items()}
    cfg = (smoke_config(args.arch, **ov) if args.smoke
           else get_config(args.arch, **ov))
    if cfg.modality == "audio_embed":
        print("[serve] audio arch: skipping (frontend stub has no "
              "tokenizer)", flush=True)
        return None
    if cfg.modality == "vlm":
        print(f"[serve] {cfg.name} is a VLM: serving its decoder text-only, "
              f"without an image prefix", flush=True)
        cfg = dataclasses.replace(cfg, prefix_len=0, modality="text")
    model = StagedLM(cfg)
    params = model.init(0, args.device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    loop = ServeLoopConfig(max_new_tokens=args.max_new_tokens,
                           max_len=args.prompt_len + args.max_new_tokens + 1)
    out = run_serving(cfg, params, prompts, loop, model=model,
                      device=args.device)
    print(f"[serve] {cfg.name} on {args.device}: prefill "
          f"{out['prefill_s'] * 1e3:.1f} ms, decode "
          f"{out['decode_tokens_per_s']:.1f} tok/s", flush=True)
    print("[serve] sample generation:", out["generations"][0][:12].tolist(),
          flush=True)
    return out


if __name__ == "__main__":
    main()
