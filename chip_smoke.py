"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and
check it, phase by phase; any failed phase ends the run with a non-zero exit.

    python3 chip_smoke.py          # from the root of a checkout

1. environment: versions, the card, and ``nvidia-smi``'s name and power limit;
2. build: the five CUDA sources (one ``nvcc`` per source, in parallel);
   then the static gate, ``python -m repro_torch.check --force
   --no-cache``: the lint, and the DP-fill kernels' analyzer (its host
   enumerator built with the host compiler), any finding failing the run;
3. host link: ``core.planner.measure_host_bandwidth``, the median of 20
   CUDA-event pinned device-to-host and host-to-device copies of one
   boundary activation's bytes (B·S·d_model bf16); the slower direction
   prices the host tier of the offload path;
4. kernel vs plain: each kernel against its plain PyTorch version on the same
   CUDA inputs — the DP kernels bit-equal (K1 and K5a on random stacked
   planes, and on random companion tables kept on the card as the per-band
   fill keeps them, every band of the L = 9 and L = 41 chains at their
   widths, without a host tier and with C3 by slice and by gather; K1, K5a,
   K2 and K5b also as whole DP tables against the numpy banded fills,
   allow_fall on and off, on random integer chains of up to 64 stages and
   on the card chain, with and without the host tier, with an activation
   wider than the budget; the card chain, L = 9, and the chain of the same
   model at its published 40 layers, L = 41, profiled on meta tensors, both
   at two budgets), flash attention within 2e-2 in bf16 (and within 2 bf16 ulps +
   2^-8 Σp|v|/l + 1e-5 of the float32 plain version on the same inputs, at
   the full shape for three seeds: the kernel rounds each p to bf16 before
   P·V) and 1e-4 in f32, at head dims 16, 64, 80, 128 and 256 (ragged
   lengths at 256, and the full shapes of the Qwen path, the Zamba2 shared
   block, 32 heads × 80, the MoE path, 16 × 128, PaliGemma's text-only
   prefill, batch 8, 8 heads × 256 on one KV head, and MusicGen's, 24 ×
   64); every bf16 instantiation must hold HGMMA (``cuobjdump -sass``:
   the tensor-core kernel at every head dim), RMSNorm within one bf16 ulp
   and rtol 1e-6 in f32 at d = 2560, 2048, 4096, 5120 and a ragged 1000 on
   an offset base, the SSD within-chunk kernel within 2e-4 (rtol and atol) in f32 (scalar
   kernel) and with bf16 x, B, C (tensor-core kernel, W and the scaled x
   split into bf16 hi + lo) against the plain version on the same values
   in f32 — at the Mamba path's full shape, a ragged sequence, heads that
   share a group, a group whose 12 heads do not fill whole slices of 8,
   the Zamba2 path's full shape (state 64: the tensor-core kernel in bf16
   too, 80 heads in slices of 8), and the Mamba and Zamba2 paths' own
   layout (x, B, C as strided views into the mixer's one xBC tensor); every
   bf16 case must take the tensor-core kernel;
5. timing: median of 20 CUDA-event runs of each kernel, its plain version and
   the PyTorch library call for the same function (none for the SSD and the
   fused DP fills), at the main paths' shapes (K1 and K5a as the per-band
   fill calls them, one launch per band on resident tables, summed over the
   bands of one fill; all four DP kernels at L = 9 and at L = 41; K3, K4
   and K6 also at the Zamba2 and MoE paths' shapes, K3 at PaliGemma's and
   MusicGen's), beside
   the least time the card could take (bytes or operations), on two
   yardsticks: one call per event pair (``ms``: the host's launch time
   counts where the card waits for it) and as device time (``*device_ms``:
   each call queued behind a sleep kernel); for the DP kernels also the
   host's own cost of the call (``host_ms``, host clock, behind a sleep
   kernel).  Then the host-clock time of whole fills at both lengths, numpy
   (``banded``), per-band (``cuda``) and fused (``cuda_fused``), host
   staging included, median of 20 with min and max, taken in turns, and
   the band kernels' device time within one ``cuda`` fill (profiler;
   :func:`time_fills`, which :func:`fill_report` runs alone for a
   parent/change comparison); where the per-band fill's time goes at
   L = 41 (host recursion, uploads, launches, downloads); and the host's
   cost of one band's copy through the library and through ``copy_``;
From phase 6 on, ``REPRO_CHECK=1`` is set: every plan is verified as
``build_plan`` returns it and again as it is bound, executed or served
(``MemoryPlan.verify``, the static verifier of ``repro_torch.check``), and
a plan that fails raises ``PlanVerificationError`` and fails the phase;
the count of verifications is printed after phase 20.  The solver cache,
plan store and frontiers live in ``build/store`` (``REPRO_STORE``),
emptied at the start, so a run reads no earlier run's entries; a DP
kernel's launch count on a path counts cache misses only (a hit launches
no fill).  Phases 7, 10 and
15 also run traced steps (``repro_torch.obs``: one span per op, CUDA-event
pairs on the stream that runs it), each written as a Perfetto file under
``build/`` and checked with ``validate_trace_file``; a traced step fails
its phase on a span count other than the schedule's op count, a span of
negative length, an invalid file, or a loss or gradient norm off
store-all's by more than 1e-2.

6. rotor path: the Qwen1.5-4B model at full width, cut to 8 layers, batch
   4 × 2048 tokens, its chain measured on real tensors
   (``launch.steps.measure_chain``: each stage alone for its sizes and its
   forward's and backward's transient memory by the allocator's peak, then
   its forward and backward times inside the chain, the median of 3 traced
   store-all steps on the walker after a warm-up (CUDA-event spans; the
   min-memory schedule where store-all does not fit), printed stage by
   stage beside the isolated times and then beside the analytic chain's,
   its sizes equal to the analytic chain's with each tensor at the CUDA
   allocator's bound) to set the budget, the midpoint between
   its min-memory and store-all peaks; then ``repro_torch.launch.train.main``
   trains 3 steps under that rotor budget on the CUDA band-min kernel, the
   launcher measuring its own chain and planning on it (a chain without
   transients fails); per step the plan's predicted activation peak over
   the measured one, over the forward and backward (less the parameter
   gradients made by then; below 1 fails) and over the whole step; then
   loss and global gradient norm under the rotor plan and under store-all
   agree within 1e-2 on one batch;
7. offload path: ``run_training`` on a measured chain under
   ``optimal_offload:BUDGET:BW`` solved on the fused fill (K5b), with BW
   the measured link and BUDGET between the chain's three-tier and
   two-tier floors (both printed) where the three-tier plan there copies a
   boundary activation (an ``a^i``, i > 0; the token batch alone is no
   activation) to the host; else the lowest of 33 budgets from the
   two-tier floor up to store-all at which it copies one and is predicted
   no slower than the two-tier plan.  The models tried, in turn, until
   one copies an activation: path 6's, the same model without per-layer
   remat, and path 11's Zamba2 (whose chunks' backward, not the head's,
   sets the floor); none fails the run.  Batch and steps as path 6.  The
   eager walker copies activations to pinned host memory and back; per
   step the host buffer must reach the copied activation's bytes and end
   empty, and the forward+backward ratio (the walker's per-op peaks, less
   the gradients made by then) must not fall below 1; then the offload
   schedule and store-all agree within 1e-2 on one batch.  The two-tier
   plan of the same budget (or of its floor) trains 3 steps first, as the
   yardstick.  Then one traced step of the offload schedule on the walker:
   its ``Foff``/``Prefetch`` spans on the side stream, the share of their
   time under compute spans, the measured stall (the compute stream's
   wait, and the ``Prefetch`` spans) against ``plan.transfer_stall``, and
   the host buffer's peak from ``host_buffer.bytes_in_use``, which must
   equal the buffer's own and reach the copied activation;
8. planning with the other fill: on each training run's measured chain,
   the offload policy on the per-band kernel (K5a) and the rotor policy on
   the fused fill (K2) give the schedules the two training runs used;
9. Mamba path: Mamba2-1.3B at full width (d_model 2048, 64 SSM heads of
   64, state 128, chunks of 256), cut to 8 layers, batch 4 × 2048 tokens:
   its chain measured on real tensors (printed stage by stage beside the
   analytic chain, sizes equal at the allocator's bound), then ``run_training(chain=measured)``
   trains 3 steps under the rotor plan solved on the CUDA band-min kernel
   at the measured chain's midpoint budget, every SSD forward on the
   hand-written kernel, its launches counted over those steps alone (the
   counters reset just before ``run_training``); per step the plan's
   predicted activation peak over the measured one, as in path 6, the
   analytic chain's floors and predicted peak beside them; then the rotor
   plan and store-all agree within 1e-2 on one batch;
10. the trade-off of paper Figs 3–13 (``launch.tradeoff``) on path 6's
    measured chain: store-all, the best sequential segment count,
    ``revolve:B`` and ``rotor:B`` at 0.45, 0.7 and 1.0 × the measured
    store-all peak and at two budgets between the two-tier floor and
    store-all, each through ``MemoryPlan.bind(...).value_and_grad``,
    predicted against measured time and peak, the time MAPE (over all
    points, and over the points whose schedule differs from store-all's,
    whose steps timed the chain; the points left out are named) and
    rotor's gain over sequential; every point's loss and gradient norm equal
    store-all's within 1e-2.  Each point also runs one traced step through
    ``bind(stages, tracer=)`` (the nested checkpoints), printed beside the
    untraced step, its loss and norm held alike; the rotor points' traces are
    written out; then per stage the measured ``uf``/``ub`` against the
    chain's (predicted, measured, ratio, the stage's share of the miss),
    the chain calibrated on the spans (``calibrate_from_trace``), every
    point re-planned on it at its budget, and the MAPE on the calibrated
    chain beside the uncalibrated one (no limit held).  Then again,
    untraced, for the same model without its per-layer remat (the paper's
    setting: the planner is the only checkpointing), its chain measured
    and printed as in path 6;
11. Zamba2 path: as path 9, Zamba2-2.7B
    at full width (d_model 2560, 80 SSM heads of 64, state 64, chunks of
    256; the shared attention+MLP block at 32 heads × 80 and d_ff 10240;
    vocab 32000), cut to 24 layers (4 periods of 6: 4 chunks, each opening
    with the shared block, a 6-stage chain), batch 4 × 2048, 3 steps, flash
    attention and the SSD kernel; the launcher must take the tensor-core
    K6 kernel at state 64 in slices of 8 heads, and the steps must launch
    K1, K3, K4 and K6;
12. MoE path: as path 9, moonshot-v1-16b-a3b at full width (d_model 2048,
    16 heads × 128, a dense first layer of d_ff 11264, then 64 routed
    experts top-6 of d_ff 1408 and 2 shared ones, capacity factor 1.25;
    vocab 163840), cut to 4 layers, one a chunk (dense | moe | moe | moe, a
    heterogeneous 6-stage chain); it must launch K1, K3 and K4;
13. the paper's own workload: the heterogeneous conv chain
    (``configs.paper_resnet``, 12 blocks from 224² × 64 down to 14² × 512,
    batch 64, float32, a synthetic input from the seed), its chain measured
    (each stage alone, then its times inside the chain, both printed) and
    printed stage by stage, then the trade-off of path 10 at 0.35, 0.5,
    0.65, 0.8 and 1.0 × store-all (the JAX package's budgets) and at two
    budgets a third and two thirds of the way from the measured two-tier
    floor to store-all, on the CUDA band-min kernel (each stage's backward
    transient measured in isolation, its ``ob``, printed beside the same
    backward inside the chain; past 5 % plus one allocator rounding apart
    it fails): predicted and measured time and peak per point, the MAPE
    (both ways, as path 10) and rotor's gain over
    sequential, measured and predicted; every point's loss and gradient
    norm equal store-all's within 1e-2, the gain must be read at two
    budgets below store-all at least, and K1 must launch;
14. MLA path: as path 9, deepseek-v2-lite-16b at full width (d_model 2048,
    16 MLA heads with a rank-512 latent, qk 128 + 64, v 128, a dense first
    layer of d_ff 10944, then 64 routed experts top-6 of d_ff 1408 and 2
    shared; vocab 102400; the attention is plain PyTorch, as in the JAX
    package), cut to 4 layers, one a chunk (a 6-stage chain); it must launch
    K1 and K4;
15. serving: Qwen1.5-4B at its published width and depth (40 layers, bf16,
    flash attention, 3.95e9 parameters), batch 8 prompts of 2048 random
    tokens, a decode cache of 2112 positions (40 blocks of 173,015,040 B),
    its prefilled size checked against ``cache_layout`` by the allocator's
    count.  (a) The whole cache on the card: 63 decode steps, each step's
    logits (two sequences) against ``forward_logits`` of the prompt and the
    tokens fed, its head only at those positions (bf16: per position max
    |Δ| ≤ ``SERVE_MAX_ERR``, mean over every checked logit ≤
    ``SERVE_MEAN_ERR``).  Then ``run_serving`` for 16 tokens three ways:
    the whole cache; ``plan=`` a ``plan_serving`` plan at 0.5 × the
    cache's blocks on the fused fill (K5b) with the measured link (the
    per-band fill, K5a, must give the same schedule); ``kv_policy="lru"``
    at the same budget.  The tokens must equal (a)'s; the KV held on the
    card between steps (``memory_allocated``) must stay within the budget;
    the planned step's peak within (a)'s less the staged bytes plus two
    blocks; the copies must move the booked bytes (and, planned, the last
    step's write-back), the planned ones no more than LRU's; the modeled
    stall and the measured wait are printed.  One more ``run_serving`` at
    the planned budget is traced: one ``Decode`` span per decode step, the
    Perfetto file valid, the tokens (a)'s, and its ``serve.*`` metrics
    equal to its returned dict.  Must launch K3, K4 and K5b;
16. serving the other archs on the whole cache: Mamba2-1.3B at its 48 layers
    (the SSD kernel, K6, in prefill), phase 11's Zamba2 (24 layers) and
    phase 14's deepseek-v2-lite (4 layers, capacity factor 16 so that decode
    and the full forward drop no token), batch 8 × 2048, prefill and 32
    decode steps against ``forward_logits`` as in 15(a).  Must launch K4 and
    K6;
17. VLM path: as path 9, paligemma-3b at its published width and depth
    (18 layers, d_model 2048, 8 heads × 256 on one KV head, GeGLU d_ff
    16384, vocab 257216, embedding scale; 3.04e9 parameters), batch 4 ×
    (256 image embeddings + 1792 tokens), the plan on the fused fill (K2);
    the bidirectional prefix takes the plain attention, so K3 does not run;
18. audio path: as path 9, musicgen-medium at its published 48 layers
    (d_model 1536, 24 heads × 64, GELU d_ff 6144, vocab 2048; 1.36e9
    parameters), batch 4 × 2048 frame embeddings with sinusoidal positions
    (an embed stage without parameters), the plan on K1; K3 at head dim 64;
19. serving at model level, batch 8 × 2048: PaliGemma text-only (as
    ``launch.serve`` serves a VLM; its prefill runs K3 at head dim 256) —
    63 decode steps against ``forward_logits`` as 15(a), then
    ``run_serving``'s 16 tokens equal to them; PaliGemma with a 256-embedding
    image prefix and 1792 tokens, 32 decode steps; MusicGen on 2048 frames,
    32 frame decode steps (each fed the next frame); each against the full
    forward within phase 15's tolerance;
20. persistence and resume (``persistence``), in the store under
    ``build/store``: (a) ``build_plan`` on the fused fill on path 6's
    measured chain, a miss with one K2 launch, then a hit with none and the
    same schedule (host-clock latency of each); (b) a child process on the
    same store: a disk hit, no fill launch; (c) the plan saved to a file,
    loaded and verified in a child with ``CUDA_VISIBLE_DEVICES=''``, then
    the loaded plan bound and run on the card: loss and gradient norm
    equal to the original plan's within 1e-2; (d) the file with one byte
    flipped and the chain with one ``uf`` changed, each refused with what
    failed named; (e) ``PlanService`` (one worker), tenants alpha and beta,
    8 concurrent identical requests: one fill (one solver-cache miss, one
    K2 launch), the ``plan_service.*`` counts printed; (f) ``sweep`` over 5
    fractions twice through the default store's frontier: the second makes
    no solve, a query between two points at most one; (g) path 9's Mamba2
    (8 layers) under rotor on its measured chain: 2 steps with
    ``ckpt_dir`` (a checkpoint after each step, written on a thread), then
    a fresh ``run_training`` resumes and takes step 3, its loss equal to 3
    uninterrupted steps' within 1e-3 relative; ``restore_plan(chain=)``
    gives the trained plan's schedule; the bytes, host-copy and write
    seconds of each checkpoint and the time the step-0 write overlapped
    step 1 printed; the directory removed after.  The time MAPE of paths
    10 and 13 is then printed again, both ways;
21. multi-device (``multi_device``): Qwen1.5-4B at full width cut to 2 layers, batch 4 × 2048 as two host slices, 3
    steps under ``rotor:`` at the measured chain's midpoint — the plain
    single-process run, then (a) ``torchrun --nproc-per-node 1 -m
    repro_torch.launch.train`` on NCCL (losses equal within rtol 1e-3, the
    plan digest, K3, K4 and K1 counted in that process); (b)
    ``compressed_psum_mean`` on one step's real gradients through NCCL at
    world 1 (largest deviation from the plain mean ≤ its scale;
    ``compression_ratio``); (c) two ranks sharing the card over gloo at
    mesh (2, 1), each on its host's slice (losses equal (a)'s, rank 0's
    parameter bytes = Σ bytes / shard factor, the first step's collective
    bytes), then deepseek-v2-lite's MoE block at full width through
    expert parallelism at world 2 against its local path (output, aux,
    gradients within rtol 2e-4 / atol 2e-5; two exchanges forward, two
    backward); (c) takes the first two steps and
    checkpoints, (d) restores it at world 1 and takes the third with (a)'s
    loss; the phase's time;
22. model-axis tensor parallelism and serving on a mesh
    (``tensor_parallel``);
23. the roofline on the card (``roofline``): (a) ``H100_SXM.hbm_bytes``
    equal to the card's ``total_memory``; (b) path 6's model, one step at
    the measured chain's midpoint counted (``FlopCounterMode`` + K3's
    FLOPs per launch) against ``train_terms`` within ``FLOP_RATIO_WINDOW``,
    the median of 3 more steps beside its terms, the share of the bound
    (max term / step) and MFU; (c) Qwen1.5-4B at 40 layers decoding batch 8
    on a 2048-position cache against ``decode_terms``; a share above 1.05
    fails either; (d) ``python -m repro_torch.launch.dryrun --arch
    qwen1.5-4b --shape train_4k`` at 256 fake ranks, the card hidden: exit
    0 and ``fits``;
24. one JSON line describing every kernel (K3's launches also by head
    dim: it must have run at 256 and 64), then the final JSON result line.

Each path (6 to 23) runs with the launch counts set to 0 just before it and
read just after (phase 21's in its torchrun process); a kernel launched on
none of them fails the run.  Every
training path's predicted forward+backward activation peak must lie
within [1, 1.25] of the measured one.

Without CUDA, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): device memory bandwidth, bf16 tensor-core
# rate, float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
SLEEP_CYCLES = 2_000_000  # ~1 ms of the card's clock, for device_ms

ARCH = "qwen1.5-4b"
LAYERS, BATCH, SEQ, STEPS = 8, 4, 2048, 3
OVERRIDES = {"num_layers": LAYERS, "layer_kinds": ["dense"] * LAYERS,
             "n_chunks": LAYERS, "use_flash_attention": True}
MAMBA_ARCH = "mamba2-1.3b"
MAMBA_OVERRIDES = {"num_layers": LAYERS, "layer_kinds": ["mamba"] * LAYERS,
                   "n_chunks": LAYERS, "use_ssd_kernel": True}
# Zamba2-2.7B cut to 4 periods of 6 layers: 4 chunks, each opening with the
# shared attention block, a 6-stage chain
ZAMBA_ARCH, ZAMBA_LAYERS = "zamba2-2.7b", 24
ZAMBA_OVERRIDES = {"num_layers": ZAMBA_LAYERS,
                   "layer_kinds": ["zamba"] * ZAMBA_LAYERS,
                   "use_flash_attention": True, "use_ssd_kernel": True}
# moonshot-v1-16b-a3b cut to its dense first layer and 3 MoE layers, one a
# chunk: dense | moe | moe | moe, a 6-stage chain
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_OVERRIDES = {"num_layers": 4, "layer_kinds": ["dense"] + ["moe"] * 3,
                 "n_chunks": 4, "use_flash_attention": True}
# deepseek-v2-lite-16b (MLA) cut alike: dense | moe | moe | moe
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_OVERRIDES = {"num_layers": 4, "layer_kinds": ["dense"] + ["moe"] * 3,
                 "n_chunks": 4}
# the paper's conv chain at ImageNet size: 224² × 64 down to 14² × 512
RESNET = {"num_blocks": 12, "base_ch": 64, "image": 224, "batch": 64}
# the VLM and the audio decoder at their published depth (18 and 48 layers)
VLM_ARCH, AUDIO_ARCH = "paligemma-3b", "musicgen-medium"
FLASH_ON = {"use_flash_attention": True}


def say(*parts) -> None:
    print(*parts, flush=True)


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Like :func:`median_ms`, but each timed call is queued behind a
    ~1-ms sleep kernel, so that the host's time to launch it (Python, ctypes,
    tensor maps) falls outside the timed window: the call's device time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median host-clock ms of one call to ``fn`` queued behind a ~1-ms
    sleep kernel, so that it returns before the card reaches its work: the
    host's own cost of the call (checks, allocations, the launch)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        t_0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t_0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def both_ms(kernel, plain, library=None) -> dict:
    """A kernel's, its plain version's and the library call's times (None
    without one) on both yardsticks: one call per event pair (``ms``, the
    host's launch time counted where the card waits for it) and behind a
    sleep kernel (``device_ms``)."""
    fns = (("", kernel), ("plain_", plain), ("library_", library))
    # the three event-pair times back to back, then the three device times,
    # so no sleep kernel runs between the calls compared on the first
    times = {f"{key}ms": None if fn is None else median_ms(fn)
             for key, fn in fns}
    times.update({f"{key}device_ms": None if fn is None else device_ms(fn)
                  for key, fn in fns})
    return times


def add_times(total: dict, times: dict) -> dict:
    """``total`` plus ``times``, key by key (bands of one fill)."""
    return {k: v if total.get(k) is None else total[k] + v
            for k, v in times.items()}


def bound(nbytes: float, ops: float, peak_ops: float):
    """(ms, "bytes"|"operations"): the least time for the work."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bf16_ulp(x):
    import torch

    mag = torch.clamp(x.abs().float(), min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def static_gate(card: str) -> None:
    """Phase 2b: ``python -m repro_torch.check --force --no-cache`` (the
    lint and the DP-fill kernel analyzer, its enumerator built by the host
    compiler here); any finding fails the run."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.check", "--force", "--no-cache"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    seconds = time.perf_counter() - t0
    for line in proc.stdout.splitlines()[:40]:
        say(f"[check] {line}")
    if proc.returncode != 0 or "kernel-analysis: ok" not in proc.stdout:
        raise AssertionError(f"python -m repro_torch.check exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    say(f"[check] the static gate passed in {seconds:.2f} s of wall time "
        f"(lint, the DP-fill kernels analyzed) on {card}")


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def sass_functions(source: str, kernel: str) -> dict:
    """``{mangled name: SASS}`` of each function of the built library of
    ``source`` whose name holds ``kernel`` (``cuobjdump -sass``)."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(source))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    found = {}
    for body in sass.split("Function :")[1:]:
        name = body.splitlines()[0].strip()
        if kernel in name:
            found[name] = body
    return found


def time_fills(fills: dict, card: str, reps: int = 20,
               profiles: int = 5) -> list:
    """Time the planner's DP fills of ``fills`` ({L: (two-tier chain,
    offload chain)}, discretized to ``DEFAULT_NUM_SLOTS`` slots) and print
    one JSON line per fill:

    - ``wall_ms``: the whole fill on the host clock for each impl
      (``banded``, ``cuda``, ``cuda_fused``), host staging included, median,
      min and max of ``reps`` calls after one, the impls taken in turns so
      that the host's drift falls on all;
    - ``band_min_device_ms``: the device time of the band-min kernels (K1 or
      K5a) within one ``cuda`` fill, from ``torch.profiler``'s kernel
      events, median of ``profiles`` fills, with their launches and the
      device time of the fill's copies.

    It reads only ``dp_kernels.fill_tables[_offload]``, which every tree of
    the port has, so :func:`fill_report` can run it in another tree."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import dp_kernels
    from repro_torch.plan import DEFAULT_NUM_SLOTS as slots

    def band_kernels(fill):
        runs = []
        for _ in range(profiles):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fill()
            kern = copies = 0.0
            launches = 0
            for e in prof.events():
                if e.device_type != DeviceType.CUDA:
                    continue
                if "band_min" in e.name:
                    kern += e.time_range.elapsed_us() / 1e3
                    launches += 1
                elif e.name.startswith("Memcpy"):
                    copies += e.time_range.elapsed_us() / 1e3
            runs.append((kern, launches, copies))
        return [statistics.median(r[i] for r in runs) for i in range(3)]

    rows = []
    for L in sorted(fills):
        for kind, dch, fill in zip(("two-tier", "offload"), fills[L],
                                   (dp_kernels.fill_tables,
                                    dp_kernels.fill_tables_offload)):
            def run(impl, dch=dch, fill=fill):
                fill(dch, slots, impl=impl)
                torch.cuda.synchronize()

            impls = ("banded", "cuda", "cuda_fused")
            times = {impl: [] for impl in impls}
            for impl in impls:
                run(impl)
            for _ in range(reps):
                for impl in impls:
                    t_0 = time.perf_counter()
                    run(impl)
                    times[impl].append((time.perf_counter() - t_0) * 1e3)
            kern, launches, copies = band_kernels(lambda: run("cuda"))
            rows.append({"chain_L": L, "fill": kind, "wall_ms": {
                impl: {"median": statistics.median(t), "min": min(t),
                       "max": max(t)} for impl, t in times.items()},
                "band_min_device_ms": kern, "band_min_launches": launches,
                "copies_device_ms": copies, "card": card})
            say(f"[fills] {json.dumps(rows[-1])}")
    return rows


def fill_report() -> int:
    """The DP fills of Qwen1.5-4B's chain cut to 8 layers (L = 9) and at its
    40 layers (L = 41), priced at a fixed 7.75e14 FLOP/s and a 5e10-B/s
    host link, through :func:`time_fills`: a parent/change comparison
    copies this file into each tree and runs, from its root,
    ``python3 -c "import chip_smoke; chip_smoke.fill_report()"``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec, input_specs
    from repro_torch.core.chain import HostTransferModel
    from repro_torch.core.solver import solve_min_memory
    from repro_torch.launch.steps import plan_chain
    from repro_torch.models.lm import StagedLM
    from repro_torch.offload.solver import solve_min_device_memory
    from repro_torch.plan import DEFAULT_NUM_SLOTS

    fills = {}
    for layers in (LAYERS, get_config(ARCH).num_layers):
        cfg = get_config(ARCH, num_layers=layers, n_chunks=layers,
                         layer_kinds=("dense",) * layers,
                         use_flash_attention=True)
        ch = plan_chain(StagedLM(cfg), input_specs(
            cfg, ShapeSpec("train", "train", SEQ, BATCH)), 7.75e14)
        hch = ch.with_host(HostTransferModel(bandwidth_d2h=5e10))
        low = solve_min_memory(ch).mem_limit
        fills[ch.length] = (
            ch.discretize((low + ch.store_all_peak()) / 2, DEFAULT_NUM_SLOTS),
            hch.discretize((solve_min_device_memory(hch).mem_limit + low) / 2,
                           DEFAULT_NUM_SLOTS))
    time_fills(fills, card_name())
    return 0


# serving (phases 15-16, 19): batch 8 prompts of 2048 positions
SERVE_BATCH, SERVE_PROMPT = 8, 2048
# bf16 decode against the full forward, per checked position: the largest
# |logit difference| (an expert choice flipping on a near-tie moves a token's
# logits by ~0.1) and the mean one over every checked logit, beyond the
# mean difference between the kernels' forward and the plain one
# (check_against_forward)
SERVE_MAX_ERR, SERVE_MEAN_ERR = 0.5, 0.01


def uncounted(fn):
    """``fn()`` with the launch counts left as they were: a check beside a
    path, not the path."""
    from repro_torch import counters
    saved = counters.snapshot()
    try:
        return fn()
    finally:
        counters.LAUNCHES.clear()
        counters.LAUNCHES.update(saved)


def on_card(model, prompt):
    """A prompt of numpy arrays as CUDA tensors, embeddings in the model
    dtype (as ``SyntheticLMData.device_batch`` hands them over)."""
    import torch

    return {k: torch.as_tensor(v, device="cuda").to(
        model.cfg.dtype if k in ("embeds", "image_embeds") else None)
        for k, v in prompt.items()}


def decode_run(tag, model, params, prompt, steps, max_len, card,
               frames=None):
    """Prefill ``prompt`` (numpy ``tokens``, or ``embeds``, or
    ``image_embeds`` and ``tokens``) and decode ``steps`` greedy steps on
    the whole cache (``StagedLM.prefill`` / ``decode_step``), keeping the
    first two sequences' logits at every new position.  A step feeds the
    last argmax token, or for an audio model the next of ``frames`` (B,
    steps, d_model).  Checks the cache against ``cache_layout`` by the
    allocator's count (what dropping it frees).  Returns ``(tokens (B,
    steps + 1), logits (2, steps + 1, V) float32, prefill ms, decode
    tokens/s)``."""
    import torch
    from repro_torch.core.planner import allocator_bytes
    from repro_torch.data.pipeline import sequence_shape

    B = sequence_shape(prompt)[0]
    batch = on_card(model, prompt)
    layout = model.cache_layout(B, max_len)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_len=max_len)
    nxt = torch.argmax(logits[:, -1], dim=-1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    seen, toks = [logits[:2, 0].float()], [nxt]
    del logits
    sizes = [t.nbytes for d in cache["layers"] + cache["shared"]
             for t in d.values()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = model.decode_step(
            params, cache, toks[-1][:, None] if frames is None
            else frames[:, i:i + 1])
        toks.append(torch.argmax(logits[:, -1], dim=-1))
        seen.append(logits[:2, 0].float())
        del logits
    torch.cuda.synchronize()
    tok_s = B * steps / (time.perf_counter() - t0)
    # the allocator's count of the cache: what dropping it frees
    held = torch.cuda.memory_allocated()
    del cache
    gc.collect()
    held -= torch.cuda.memory_allocated()
    say(f"[serve] {tag}: cache_layout({B}, {max_len}): "
        f"{len(layout.block_bytes)} blocks, block_bytes {sorted(set(layout.block_bytes))}, "
        f"token_bytes {layout.token_bytes}, static_bytes "
        f"{layout.static_bytes}, allocated_bytes {layout.allocated_bytes}; "
        f"the cache's tensors {sum(sizes)} B, the allocator's count {held} "
        f"B; prefill {prefill_ms:.3f} ms on {card}")
    if sum(sizes) != layout.allocated_bytes - 4 or not (
            sum(sizes) <= held <= sum(map(allocator_bytes, sizes))):
        raise AssertionError(f"{tag}: the cache ({sum(sizes)} B, the "
                             f"allocator's {held} B) is not cache_layout's "
                             f"{layout.allocated_bytes} B less pos")
    torch.cuda.empty_cache()
    return (torch.stack(toks, 1).cpu().numpy(), torch.stack(seen, 1),
            prefill_ms, tok_s)


def check_against_forward(tag, model, params, prompt, tokens, seen, card,
                          frames=None):
    """Each decode position's logits (first two sequences) against
    ``forward_logits`` of the prompt and the tokens (or ``frames``) fed,
    its head computed only at those positions.  Fails past
    ``SERVE_MAX_ERR`` at a position, or past ``SERVE_MEAN_ERR`` in the
    mean beyond the floor: the mean
    difference between that forward and the same forward on the kernels'
    plain versions (flash attention and the SSD kernel off), two valid bf16
    forwards of the same logits."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.data.pipeline import sequence_shape
    from repro_torch.models.lm import StagedLM

    S0, n = sequence_shape(prompt)[1], seen.shape[1]
    whole = {k: v[:2] for k, v in prompt.items()}
    if frames is None:
        whole["tokens"] = np.concatenate(
            [whole["tokens"], tokens[:2, :n - 1].astype(np.int32)], axis=1)
    else:
        whole["embeds"] = np.concatenate(
            [whole["embeds"], frames[:2, :n - 1].float().cpu().numpy()],
            axis=1)
    whole = on_card(model, whole)
    at = slice(S0 - 1, S0 - 1 + n)
    ref = model.forward_logits(params, whole, at=at).float()
    plain = StagedLM(dataclasses.replace(
        model.cfg, use_flash_attention=False, use_ssd_kernel=False))
    floor = float((plain.forward_logits(params, whole, at=at)
                   .float() - ref).abs().mean())
    err = (seen - ref).abs()
    worst, mean = float(err.amax()), float(err.mean())
    per_pos = err.mean(dim=(0, 2))
    say(f"[serve] {tag}: {n} positions x 2 sequences against forward_logits:"
        f" max |err| {worst:.4f} (tol {SERVE_MAX_ERR}), mean |err| "
        f"{mean:.6f} (tol {SERVE_MEAN_ERR} + the floor {floor:.6f}, the "
        f"forward on the plain versions against it; at the prefill's "
        f"position {float(per_pos[0]):.6f}, per position "
        f"{[round(float(x), 4) for x in per_pos]}), max |logit| "
        f"{float(ref.abs().max()):.3f} on {card}")
    if not (worst <= SERVE_MAX_ERR and mean <= SERVE_MEAN_ERR + floor):
        raise AssertionError(f"{tag}: decode differs from the full forward")


def traced_serving(cfg, params, prompts, loop, model, plan, budget, want,
                   card) -> None:
    """Phase 15's traced run: ``run_serving`` with a tracer at the planned
    budget; one ``Decode`` span per decode step, the Perfetto file under
    build/ valid, the ``serve.*`` metrics (this run's readings, counters
    as their growth over it) equal to the returned dict and the tokens
    ``want``."""
    import numpy as np
    from repro_torch.obs import metrics
    from repro_torch.obs.trace import Tracer, validate_trace_file
    from repro_torch.runtime.serve_loop import run_serving

    reg = metrics.registry()

    def total(name):
        m = reg.get(name)
        return 0.0 if m is None else m.total

    before = {k: total(k) for k in ("serve.decode_tokens",
                                    "serve.kv_transfer_bytes")}
    tracer = Tracer(name="phase 15 serving")
    r = run_serving(cfg, params, prompts, loop, model, tracer, plan=plan,
                    kv_budget=budget)
    if not np.array_equal(r["generations"], want):
        raise AssertionError("qwen traced: greedy tokens differ from (a)'s")
    decodes = [s for s in tracer.spans if s.op == "Decode"]
    if [s.arg for s in decodes] != list(range(1, loop.max_new_tokens)):
        raise AssertionError(f"qwen traced: {len(decodes)} Decode spans for "
                             f"{loop.max_new_tokens - 1} decode steps")
    path = ROOT / "build" / "trace_phase15_serving.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    tracer.save(str(path))
    n = validate_trace_file(str(path))
    gauges = {
        "serve.kv_bytes": (reg.get("serve.kv_bytes").value, r["kv_bytes"]),
        "serve.kv_bytes_allocated": (
            reg.get("serve.kv_bytes_allocated").value,
            r["kv_bytes_allocated"]),
        "serve.decode_tokens": (
            total("serve.decode_tokens") - before["serve.decode_tokens"],
            r["decode_tokens"]),
        "serve.prefill_seconds": (reg.get("serve.prefill_seconds").last,
                                  r["prefill_s"]),
        "serve.kv_transfer_bytes": (
            total("serve.kv_transfer_bytes")
            - before["serve.kv_transfer_bytes"], r["kv_transfer_bytes"]),
        "serve.kv_stall_seconds": (reg.get("serve.kv_stall_seconds").last,
                                   r["kv_stall_s"])}
    for name, (got, exp) in gauges.items():
        if got != exp:
            raise AssertionError(f"qwen traced: {name} {got} but the "
                                 f"returned dict says {exp}")
    step = sorted(s.duration for s in decodes)[len(decodes) // 2]
    say(f"[serve] qwen traced (plan= at the same budget): {len(decodes)} "
        f"Decode spans, median {step * 1e3:.3f} ms; {n} spans in "
        f"{path.relative_to(ROOT)} (valid); decode "
        f"{r['decode_tokens_per_s']:.2f} tokens/s; serve.* metrics == the "
        f"returned dict: {json.dumps({k: v[0] for k, v in gauges.items()})}"
        f"; tokens == (a)'s on {card}")


def serve_qwen(card, host) -> dict:
    """Phase 15: Qwen1.5-4B served at its published width and depth — the
    whole cache, then ``plan=`` and LRU at half of it on the link ``host``;
    returns the phase's launch counts."""
    import numpy as np
    import torch
    from repro_torch import counters
    from repro_torch.configs import get_config
    from repro_torch.kernels.dp_fill import ops as dp_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.models.lm import StagedLM
    from repro_torch.plan.serving import kv_residency_layers, plan_serving
    from repro_torch.runtime.serve_loop import ServeLoopConfig, run_serving
    from repro_torch.tree import tensors_of

    dev = torch.device("cuda")
    B, S0 = SERVE_BATCH, SERVE_PROMPT
    NEW, SHORT = 64, 16
    max_len = S0 + NEW
    cfg = get_config("qwen1.5-4b", use_flash_attention=True)
    model = StagedLM(cfg)
    params = model.init(0, dev)
    n_params = sum(t.numel() for t in tensors_of(params))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S0)).astype(np.int32)
    say(f"[serve] qwen1.5-4b at its published width and depth: "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"x {cfg.head_dim}, vocab {cfg.vocab_size}, bf16, {n_params} "
        f"parameters ({n_params * 2} B); batch {B} x {S0} prompt tokens")
    counters.reset()
    tokens_a, seen, prefill_ms, tok_s = decode_run(
        "qwen (a) whole cache", model, params, {"tokens": prompts}, NEW - 1,
        max_len, card)
    say(f"[serve] qwen (a) whole cache: prefill {prefill_ms:.3f} ms, decode "
        f"{tok_s:.2f} tokens/s ({B} x {NEW - 1} steps) on {card}")
    loop = ServeLoopConfig(max_new_tokens=SHORT, max_len=max_len)
    layout = model.cache_layout(B, max_len)
    total = sum(layout.block_bytes)
    budget = 0.5 * total
    runs = {"whole cache": run_serving(cfg, params, prompts, loop,
                                       model=model)}
    plans = {impl: plan_serving(cfg, budget, batch=B, prompt_len=S0,
                                max_len=max_len, host=host, impl=impl)
             for impl in ("cuda_fused", "cuda")}
    plan = plans["cuda_fused"]
    runs["planned"] = run_serving(cfg, params, prompts, loop, model=model,
                                  plan=plan, kv_budget=budget)
    runs["lru"] = run_serving(cfg, params, prompts, loop, model=model,
                              kv_policy="lru", kv_budget=budget, host=host)
    launched = counters.snapshot()
    traced_serving(cfg, params, prompts, loop, model, plan, budget,
                   tokens_a[:, :SHORT], card)
    uncounted(lambda: check_against_forward(
        "qwen (a) whole cache", model, params, {"tokens": prompts}, tokens_a,
        seen, card))
    del seen
    if plans["cuda"].schedule.ops != plan.schedule.ops:
        raise AssertionError("plan_serving: cuda (K5a) and cuda_fused (K5b) "
                             "give different schedules")
    staged = kv_residency_layers(plan, budget_bytes=budget)
    staged_bytes = sum(layout.block_bytes[j] for j in staged)
    largest = max(layout.block_bytes[j] for j in staged)
    say(f"[serve] qwen (b) plan_serving at 0.5 x {total} B = {int(budget)} B "
        f"on cuda_fused (== cuda's schedule, {len(plan.schedule.ops)} ops), "
        f"link {host.bandwidth_d2h:.6e} B/s: {len(staged)} layers staged "
        f"({staged_bytes} B) {staged}; predicted stall "
        f"{plan.transfer_stall:.6e} s")
    whole = runs["whole cache"]
    for name, r in runs.items():
        if not np.array_equal(r["generations"], tokens_a[:, :SHORT]):
            raise AssertionError(f"qwen {name}: greedy tokens differ from "
                                 f"(a)'s")
        say(f"[serve] qwen {name}: prefill {r['prefill_s'] * 1e3:.3f} ms, "
            f"decode {r['decode_tokens_per_s']:.2f} tokens/s, device KV "
            f"between steps max {max(r['device_kv_bytes'])} B, step peak "
            f"max {max(r['step_peak_bytes'])} B"
            + ("" if name == "whole cache" else
               f", transfers {int(r['kv_transfer_bytes'])} B booked, "
               f"{r['kv_copied_bytes']} B copied, modeled stall "
               f"{r['kv_stall_s']:.6e} s, measured wait "
               f"{r['kv_wait_s']:.6e} s")
            + (f", hits {r['kv_lru_hits']} misses {r['kv_lru_misses']}"
               if name == "lru" else "") + f"; tokens == (a)'s on {card}")
    for name in ("planned", "lru"):
        r = runs[name]
        if max(r["device_kv_bytes"]) > budget:
            raise AssertionError(f"qwen {name}: {max(r['device_kv_bytes'])} "
                                 f"B of KV on the card between steps, over "
                                 f"the budget {budget}")
        # the planned policy also writes back behind the last step, which
        # the reference books nowhere
        unbooked = staged_bytes if name == "planned" else 0
        if r["kv_copied_bytes"] != r["kv_transfer_bytes"] + unbooked:
            raise AssertionError(f"qwen {name}: copied {r['kv_copied_bytes']}"
                                 f" B, booked {r['kv_transfer_bytes']} B")
    steps = SHORT - 1
    want = staged_bytes * (2 * steps)          # the first staging included
    if runs["planned"]["kv_transfer_bytes"] != want:
        raise AssertionError(f"qwen planned: "
                             f"{runs['planned']['kv_transfer_bytes']} B "
                             f"booked, the model's count {want}")
    if runs["planned"]["kv_transfer_bytes"] > runs["lru"]["kv_transfer_bytes"]:
        raise AssertionError("qwen: planned moves more than LRU")
    limit = max(whole["step_peak_bytes"]) - staged_bytes + 2 * largest
    if max(runs["planned"]["step_peak_bytes"]) > limit:
        raise AssertionError(f"qwen planned: step peak "
                             f"{max(runs['planned']['step_peak_bytes'])} B "
                             f"over (a)'s less the staged bytes plus two "
                             f"blocks, {limit} B")
    say(f"[serve] qwen: planned step peak "
        f"{max(runs['planned']['step_peak_bytes'])} B <= {limit} B ((a)'s "
        f"{max(whole['step_peak_bytes'])} - {staged_bytes} staged + 2 x "
        f"{largest}); planned moves "
        f"{int(runs['planned']['kv_transfer_bytes'])} B <= LRU's "
        f"{int(runs['lru']['kv_transfer_bytes'])} B")
    for name in (flash_ops.NAME, rms_ops.NAME, dp_ops.NAME_FUSED_OFFLOAD):
        if not launched.get(name):
            raise AssertionError(f"phase 15 never launched {name}")
    say(f"[serve] phase 15 launches: {json.dumps(launched)}")
    del params, runs, plans, plan
    torch.cuda.empty_cache()
    return launched


def serve_archs(card) -> dict:
    """Phase 16: Mamba2, Zamba2 and deepseek-v2-lite served on the whole
    cache, each decode position against the full forward; returns the
    phase's launch counts."""
    import numpy as np
    import torch
    from repro_torch import counters
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models.lm import StagedLM
    from repro_torch.tree import tensors_of

    dev = torch.device("cuda")
    B, S0 = SERVE_BATCH, SERVE_PROMPT
    STEPS16 = 32
    counters.reset()
    for arch, overrides, what in (
            (MAMBA_ARCH, {"use_ssd_kernel": True}, "its published 48 layers"),
            (ZAMBA_ARCH, ZAMBA_OVERRIDES, "phase 11's 24 layers"),
            (MLA_ARCH, {**MLA_OVERRIDES, "moe_capacity_factor": 16.0},
             "phase 14's 4 layers, capacity factor 16 (no token dropped, so "
             "decode and the full forward route alike)")):
        acfg = get_config(arch, **{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in overrides.items()})
        amodel = StagedLM(acfg)
        aparams = amodel.init(0, dev)
        aprompts = np.random.default_rng(1).integers(
            0, acfg.vocab_size, (B, S0)).astype(np.int32)
        say(f"[serve] {arch} at {what}: "
            f"{sum(t.numel() for t in tensors_of(aparams))} parameters")
        toks, aseen, pms, ts = decode_run(arch, amodel, aparams,
                                          {"tokens": aprompts}, STEPS16,
                                          S0 + STEPS16, card)
        say(f"[serve] {arch}: prefill {pms:.3f} ms, decode {ts:.2f} tokens/s "
            f"({B} x {STEPS16} steps) on {card}")
        uncounted(lambda: check_against_forward(
            arch, amodel, aparams, {"tokens": aprompts}, toks, aseen, card))
        del aparams, aseen
        torch.cuda.empty_cache()
    launched = counters.snapshot()
    for name in (rms_ops.NAME, ssd_ops.NAME):
        if not launched.get(name):
            raise AssertionError(f"phase 16 never launched {name}")
    say(f"[serve] phase 16 launches: {json.dumps(launched)}")
    return launched


def serve_vlm_audio(card) -> dict:
    """Phase 19: PaliGemma and MusicGen served at their published depth.
    PaliGemma text-only (its Gemma decoder, embedding scale kept, no image
    prefix, as ``launch.serve`` serves a VLM): prefill (K3 at head dim 256)
    and decode steps against the full forward, then ``run_serving`` with
    the same greedy tokens; then a VLM prompt of 256 image embeddings and
    1792 tokens (the bidirectional prefix: plain attention) and decode
    steps; MusicGen on frames (K3 at head dim 64) and frame decode steps.
    Returns the launch counts of the PaliGemma part and of the MusicGen
    part."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import counters
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.lm import StagedLM
    from repro_torch.runtime.serve_loop import ServeLoopConfig, run_serving
    from repro_torch.tree import tensors_of

    dev = torch.device("cuda")
    B, S0 = SERVE_BATCH, SERVE_PROMPT
    NEW, SHORT, STEPS19 = 64, 16, 32
    rng = np.random.default_rng(2)
    launched = {}

    vcfg = get_config(VLM_ARCH, use_flash_attention=True)
    vmodel = StagedLM(vcfg)
    params = vmodel.init(0, dev)
    say(f"[serve] {VLM_ARCH} at its published width and depth: "
        f"{vcfg.num_layers} layers, d_model {vcfg.d_model}, {vcfg.n_heads} "
        f"heads x {vcfg.head_dim} on {vcfg.n_kv_heads} KV head, vocab "
        f"{vcfg.vocab_size}, embedding scale {vcfg.embed_scale}, "
        f"{sum(t.numel() for t in tensors_of(params))} parameters")
    counters.reset()
    # (a) text-only: the decoder as launch.serve serves a VLM
    tcfg = dataclasses.replace(vcfg, prefix_len=0, modality="text")
    tmodel = StagedLM(tcfg)
    prompts = rng.integers(0, tcfg.vocab_size, (B, S0)).astype(np.int32)
    toks, seen, pms, ts = decode_run(
        f"{VLM_ARCH} text-only", tmodel, params, {"tokens": prompts},
        NEW - 1, S0 + NEW, card)
    say(f"[serve] {VLM_ARCH} text-only: prefill {pms:.3f} ms, decode "
        f"{ts:.2f} tokens/s ({B} x {NEW - 1} steps) on {card}")
    run = run_serving(tcfg, params, prompts, ServeLoopConfig(
        max_new_tokens=SHORT, max_len=S0 + NEW), model=tmodel)
    if not np.array_equal(run["generations"], toks[:, :SHORT]):
        raise AssertionError(f"{VLM_ARCH} run_serving: greedy tokens differ "
                             f"from the decode loop's")
    say(f"[serve] {VLM_ARCH} text-only run_serving: prefill "
        f"{run['prefill_s'] * 1e3:.3f} ms, decode "
        f"{run['decode_tokens_per_s']:.2f} tokens/s, tokens == the decode "
        f"loop's on {card}")
    if not counters.snapshot().get(flash_ops.NAME):
        raise AssertionError(f"{VLM_ARCH} text-only prefill never launched "
                             f"K3 at head dim {vcfg.head_dim}")
    uncounted(lambda: check_against_forward(
        f"{VLM_ARCH} text-only", tmodel, params, {"tokens": prompts}, toks,
        seen, card))
    del seen, run
    # (b) the VLM: an image prefix of 256 embeddings, then 1792 tokens
    P = vcfg.prefix_len
    vprompt = {"image_embeds": rng.standard_normal(
        (B, P, vcfg.d_model)).astype(np.float32),
        "tokens": rng.integers(0, vcfg.vocab_size,
                               (B, S0 - P)).astype(np.int32)}
    toks, seen, pms, ts = decode_run(
        f"{VLM_ARCH} image prefix", vmodel, params, vprompt, STEPS19,
        S0 + STEPS19, card)
    say(f"[serve] {VLM_ARCH} with a {P}-embedding image prefix and "
        f"{S0 - P} tokens: prefill {pms:.3f} ms, decode {ts:.2f} tokens/s "
        f"({B} x {STEPS19} steps) on {card}")
    uncounted(lambda: check_against_forward(
        f"{VLM_ARCH} image prefix", vmodel, params, vprompt, toks, seen,
        card))
    launched["serve_paligemma"] = counters.snapshot()
    del params, seen
    torch.cuda.empty_cache()

    # (c) MusicGen on frames; each decode step feeds the next frame
    acfg = get_config(AUDIO_ARCH, use_flash_attention=True)
    amodel = StagedLM(acfg)
    params = amodel.init(0, dev)
    n_params = sum(t.numel() for t in tensors_of(params))
    say(f"[serve] {AUDIO_ARCH} at its published width and depth: "
        f"{acfg.num_layers} layers, d_model {acfg.d_model}, {acfg.n_heads} "
        f"heads x {acfg.head_dim}, {n_params} parameters; frames of random "
        f"embeddings")
    counters.reset()
    aprompt = {"embeds": rng.standard_normal(
        (B, S0, acfg.d_model)).astype(np.float32)}
    frames = torch.as_tensor(rng.standard_normal(
        (B, STEPS19, acfg.d_model)).astype(np.float32),
        device=dev).to(acfg.dtype)
    toks, seen, pms, ts = decode_run(
        AUDIO_ARCH, amodel, params, aprompt, STEPS19, S0 + STEPS19, card,
        frames=frames)
    say(f"[serve] {AUDIO_ARCH}: prefill {pms:.3f} ms, decode {ts:.2f} "
        f"frames/s ({B} x {STEPS19} steps) on {card}")
    launched["serve_musicgen"] = counters.snapshot()
    uncounted(lambda: check_against_forward(
        AUDIO_ARCH, amodel, params, aprompt, toks, seen, card, frames=frames))
    if not launched["serve_musicgen"].get(flash_ops.NAME):
        raise AssertionError(f"{AUDIO_ARCH} prefill never launched K3 at "
                             f"head dim {acfg.head_dim}")
    say(f"[serve] phase 19 launches: {json.dumps(launched)}")
    del params, seen, frames
    torch.cuda.empty_cache()
    return launched


# one child process of phase 20: argv = (src, the chain's .npz, what, arg);
# "solve" plans on the fused fill (a disk hit must launch no fill kernel),
# "load" loads and verifies a saved plan (run with CUDA hidden)
PERSIST_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from repro_torch import counters
from repro_torch.core import solver_cache
from repro_torch.core.chain import Chain
from repro_torch.plan import Budget, MemoryPlan, PlanRequest, build_plan
arrays = np.load(sys.argv[2])
chain = Chain.make(**{k: arrays[k] for k in arrays.files})
if sys.argv[3] == "solve":
    plan = build_plan(PlanRequest(strategy="optimal", impl="cuda_fused",
                                  budget=Budget.bytes(float(sys.argv[4]))),
                      chain)
    out = {"stats": solver_cache.stats(), "launches": counters.snapshot()}
else:
    import torch
    plan = MemoryPlan.load(sys.argv[4], chain=chain)
    out = {"cuda": torch.cuda.is_available(), "verified": plan.verify().ok}
out["ops"] = [list(op) for op in plan.schedule.ops]
print(json.dumps(out))
"""


def persistence(card, model, chain, batch, mcfg, mchain) -> dict:
    """Phase 20: the solver cache, plan store, save/load, plan service,
    warm-start frontier and checkpoints on the card.  ``model``, ``chain``
    and ``batch`` are the Qwen path's (phase 6's measured chain), ``mcfg``
    and ``mchain`` the Mamba path's config and measured chain.  Returns the
    phase's launch counts."""
    import shutil
    import threading

    import numpy as np
    import torch

    from repro_torch import counters
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core import solver_cache
    from repro_torch.core.solver import solve_min_memory
    from repro_torch.kernels.dp_fill import ops as dp_ops
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.optim.adamw import global_norm
    from repro_torch.plan import (Budget, MemoryPlan, PlanRequest,
                                  StalePlanError, build_plan, sweep)
    from repro_torch.runtime import PlanService
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training
    from repro_torch.store import default_store
    from repro_torch.tree import tensors_of

    dev = torch.device("cuda")
    build = ROOT / "build"
    fused = dp_ops.NAME_FUSED
    launched = {}

    def tally(counts):
        for k, v in counts.items():
            launched[k] = launched.get(k, 0) + v

    def child(what, arg, hide_cuda=False):
        npz = build / "persist_chain.npz"
        np.savez(npz, **{k: np.asarray(getattr(chain, k)) for k in
                         ("uf", "ub", "wa", "wabar", "wdelta", "of", "ob")})
        env = dict(os.environ)
        if hide_cuda:
            env["CUDA_VISIBLE_DEVICES"] = ""
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", PERSIST_CHILD, str(ROOT / "src"),
             str(npz), what, arg], env=env, capture_output=True, text=True,
            timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"child {what} failed: {out.stderr[-2000:]}")
        return json.loads(out.stdout.strip().splitlines()[-1]), \
            time.perf_counter() - t0

    peak = chain.store_all_peak()
    low = solve_min_memory(chain).mem_limit
    say(f"[persist] store {default_store().uri()} (REPRO_STORE), emptied at "
        f"the start of the run; Qwen's measured chain L={chain.length}, "
        f"min-memory {low:.6e} B, store-all {peak:.6e} B on {card}")
    solver_cache.get_cache().clear()

    # (a) a miss, then a hit, in this process
    budget = low + (peak - low) * 0.6
    req = PlanRequest(strategy="optimal", impl="cuda_fused",
                      budget=Budget.bytes(budget))
    runs = []
    for what in ("miss", "hit"):
        counters.reset()
        before = solver_cache.stats()
        t0 = time.perf_counter()
        plan = build_plan(req, chain)
        seconds = time.perf_counter() - t0
        got = counters.snapshot()
        tally(got)
        after = solver_cache.stats()
        runs.append((plan, got, seconds))
        say(f"[persist] (a) build_plan on cuda_fused, {what}: "
            f"{seconds * 1e3:.3f} ms host clock, fill launches "
            f"{json.dumps(got)}, solver cache hits "
            f"{after['hits'] - before['hits']} / misses "
            f"{after['misses'] - before['misses']} on {card}")
    (plan, miss, _), (again, hit, _) = runs
    if miss != {fused: 1} or hit or again.schedule.ops != plan.schedule.ops:
        raise AssertionError(f"(a) miss launches {miss}, hit launches {hit}, "
                             f"same schedule "
                             f"{again.schedule.ops == plan.schedule.ops}")
    ops = [list(op) for op in plan.schedule.ops]

    # (b) another process on the same store: a disk hit
    out, seconds = child("solve", repr(budget))
    say(f"[persist] (b) a child process on the same store: solver cache "
        f"{json.dumps(out['stats'])}, fill launches "
        f"{json.dumps(out['launches'])}, {seconds:.2f} s with its start-up "
        f"on {card}")
    if (out["stats"]["disk_hits"] != 1 or out["launches"]
            or out["ops"] != ops):
        raise AssertionError(f"(b) not a disk hit without launches: {out}")

    # (c) save here, load with CUDA hidden, execute the loaded plan here
    path = build / "qwen_rotor.plan"
    plan.save(str(path))
    out, seconds = child("load", str(path), hide_cuda=True)
    say(f"[persist] (c) {path.relative_to(ROOT)} ({path.stat().st_size} B) "
        f"loaded in a child with CUDA_VISIBLE_DEVICES='' (cuda available: "
        f"{out['cuda']}): verified {out['verified']}, schedule identical "
        f"{out['ops'] == ops}")
    if out["cuda"] or not out["verified"] or out["ops"] != ops:
        raise AssertionError(f"(c) the child's load: {out}")
    loaded = MemoryPlan.load(str(path), chain=chain)
    params = model.init(0, dev)
    sp = model.stage_params(params)
    res = {}
    counters.reset()
    for name, p in (("original", plan), ("loaded", loaded)):
        loss, grads, _ = p.bind(model.stage_fns()).value_and_grad(sp, batch)
        res[name] = (float(loss), float(global_norm(tensors_of(
            model.combine_stage_grads(grads)))))
        del loss, grads
    tally(counters.snapshot())
    (l0, g0), (l1, g1) = res["original"], res["loaded"]
    say(f"[persist] (c) executed on the card: loss {l1:.6f} / {l0:.6f}, "
        f"grad norm {g1:.6f} / {g0:.6f} (loaded / original, rel tol 1e-2)")
    if not (abs(l1 - l0) <= 1e-2 * abs(l0) and abs(g1 - g0) <= 1e-2 * g0):
        raise AssertionError("(c) the loaded plan's loss or gradient norm "
                             "differs from the original's")
    del params, sp
    torch.cuda.empty_cache()

    # (d) a byte-tampered file and a stale chain are refused
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    bad = build / "qwen_rotor_tampered.plan"
    bad.write_bytes(bytes(data))
    stale = chain.calibrate(uf=[chain.uf[0] * 1.01]
                            + [float("nan")] * chain.length)
    for tag, target, ch, err in (("byte-tampered file", bad, chain,
                                  ValueError),
                                 ("chain with stage 1's uf x1.01", path,
                                  stale, StalePlanError)):
        try:
            MemoryPlan.load(str(target), chain=ch)
        except err as e:
            say(f"[persist] (d) {tag}: refused ({type(e).__name__}: {e})")
        else:
            raise AssertionError(f"(d) the {tag} was loaded")

    # (e) the plan service: two tenants, 8 concurrent identical requests
    req_e = PlanRequest(strategy="optimal", impl="cuda_fused",
                        budget=Budget.bytes(low + (peak - low) * 0.4))
    snap0 = obs_metrics.snapshot()
    before = solver_cache.stats()
    counters.reset()
    futures, errors = [], []
    with PlanService(default_store(), workers=1) as svc:
        def submit(tenant):
            try:
                futures.append(svc.submit(chain, req_e, tenant=tenant))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)
        threads = [threading.Thread(target=submit, args=(("alpha", "beta")
                                                         [i % 2],))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        plans = [fut.result(timeout=120) for fut in futures]
    got = counters.snapshot()
    tally(got)
    snap1 = obs_metrics.snapshot()
    svc_counts = {k: snap1[k]["count"] - snap0.get(k, {}).get("count", 0)
                  for k in sorted(snap1) if k.startswith("plan_service.")}
    fills = solver_cache.stats()["misses"] - before["misses"]
    say(f"[persist] (e) PlanService, tenants alpha and beta, 8 concurrent "
        f"identical requests: {json.dumps(svc_counts)}; solver cache misses "
        f"{fills}, fill launches {json.dumps(got)} on {card}")
    if (errors or len(plans) != 8 or fills != 1 or got != {fused: 1}
            or any(p.schedule.ops != plans[0].schedule.ops for p in plans)):
        raise AssertionError(f"(e) not one solve for 8 requests: errors "
                             f"{errors}, {len(plans)} plans, {fills} fills, "
                             f"launches {got}")

    # (f) sweep twice through the default store's warm-start frontier
    lo = low / peak
    fracs = [lo + (1.0 - lo) * k / 4 for k in range(5)]
    tmpl = PlanRequest(strategy="optimal", impl="cuda_fused")
    solves = []
    for what, fr in (("first sweep", fracs), ("second sweep", fracs),
                     ("a query between two points",
                      [(fracs[1] + fracs[2]) / 2])):
        n0 = obs_metrics.value("frontier.solves")
        counters.reset()
        t0 = time.perf_counter()
        points = sweep(chain, fr, tmpl)
        seconds = time.perf_counter() - t0
        got = counters.snapshot()
        tally(got)
        solves.append(int(obs_metrics.value("frontier.solves") - n0))
        say(f"[persist] (f) {what} over {len(fr)} fractions: "
            f"{solves[-1]} solves, fill launches {json.dumps(got)}, "
            f"{sum(p.feasible for p in points)} feasible, "
            f"{seconds * 1e3:.3f} ms host clock on {card}")
    if solves[1] != 0 or solves[2] > 1:
        raise AssertionError(f"(f) solves per sweep {solves}")

    # (g) Mamba2's 8 layers under rotor: 2 steps with checkpoints, a
    # resumed run takes step 3, against 3 uninterrupted steps
    ckpt = build / "ckpt_mamba"
    shutil.rmtree(ckpt, ignore_errors=True)
    mbudget = (solve_min_memory(mchain).mem_limit
               + mchain.store_all_peak()) / 2
    base = dict(global_batch=BATCH, seq_len=SEQ, log_every=1,
                policy=f"rotor:{int(mbudget)}", solver_impl="cuda")
    with_ckpt = dict(base, ckpt_dir=str(ckpt), ckpt_every=1, ckpt_keep=1,
                     async_ckpt=True)
    counters.reset()
    first = run_training(mcfg, TrainLoopConfig(steps=2, **with_ckpt),
                         device=dev, chain=mchain, log_fn=say)
    tally(counters.snapshot())
    saves = first["ckpt_saves"]
    wrote = sum(s["bytes"] for s in saves)
    plan_a = first["plan"]
    s0 = saves[0]
    step1 = first["steps"][1]
    overlap = max(0.0, min(s0["t_write_end"], step1["t_end"])
                  - max(s0["t_write_start"], step1["t_start"]))
    say(f"[persist] (g) checkpoints of {mcfg.name} ({mcfg.num_layers} "
        f"layers): " + "; ".join(
            f"step {s['step']}: {s['bytes']} B, host copy "
            f"{s['snapshot_s']:.3f} s, write {s['write_s']:.3f} s "
            f"({'blocking' if s['blocking'] else 'on a thread'})"
            for s in saves)
        + f"; the step-0 write overlapped step 1 for {overlap:.3f} s of its "
        f"{s0['write_s']:.3f} s ({overlap / s0['write_s']:.4f}), step 1 "
        f"took {step1['seconds']:.3f} s on {card}")
    del first
    torch.cuda.empty_cache()
    counters.reset()
    resumed = run_training(mcfg, TrainLoopConfig(steps=3, **with_ckpt),
                           device=dev, chain=mchain, log_fn=say)
    tally(counters.snapshot())
    wrote += sum(s["bytes"] for s in resumed["ckpt_saves"])
    if resumed["start_step"] != 2 or len(resumed["losses"]) != 1:
        raise AssertionError(f"(g) resumed at {resumed['start_step']} with "
                             f"{len(resumed['losses'])} steps")
    restored = CheckpointManager(str(ckpt)).restore_plan(chain=mchain)
    del resumed["params"], resumed["opt_state"]
    torch.cuda.empty_cache()
    counters.reset()
    straight = run_training(mcfg, TrainLoopConfig(steps=3, **base),
                            device=dev, chain=mchain, log_fn=say)
    tally(counters.snapshot())
    a, b = resumed["losses"][0], straight["losses"][2]
    say(f"[persist] (g) step 3 resumed from the checkpoint: loss {a:.6f}, "
        f"uninterrupted {b:.6f} (rel {abs(a - b) / abs(b):.3e}, tol 1e-3); "
        f"restore_plan(chain=) schedule identical "
        f"{restored.schedule.ops == plan_a.schedule.ops}; {wrote} B written "
        f"in {len(saves) + len(resumed['ckpt_saves'])} checkpoints on {card}")
    if not abs(a - b) <= 1e-3 * abs(b):
        raise AssertionError("(g) the resumed step's loss differs from the "
                             "uninterrupted run's")
    if restored.schedule.ops != plan_a.schedule.ops:
        raise AssertionError("(g) restore_plan gave another schedule")
    del straight, resumed
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return launched


# -- phase 21: multi-device ----------------------------------------------------

# Qwen1.5-4B at full width cut to 2 layers, batch 4 × 2048 over the ranks
MD_OVERRIDES = {"num_layers": 2, "layer_kinds": ["dense"] * 2, "n_chunks": 2,
                "use_flash_attention": True}
EP_ARCH = "deepseek-v2-lite-16b"   # one MoE layer's block, at full width
EP_BATCH = 2

def _ep_rank(rank, world, seed, count):
    """deepseek-v2-lite's MoE block at full width (float32 weights and
    input from ``seed``, identical on every rank): the expert-parallel path
    on a ``(1, world)`` mesh against the local path on the same input: output,
    aux, and the gradients of the input, router and this rank's expert
    blocks, as max |Δ| and the allowance rtol 2e-4 / atol 2e-5 gives
    each; the exchange counts; the device time of each path's forward and
    backward (CUDA events, median of ``count``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import axis_rules, make_mesh
    from repro_torch.models import mlp as mlp_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(EP_ARCH, dtype=torch.float32, param_dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = mlp_mod.moe_init(gen, cfg, torch.float32, dev)
    x = torch.randn((EP_BATCH, SEQ, cfg.d_model), generator=gen, device=dev)
    cot = torch.randn(x.shape, generator=gen, device=dev)
    e_loc = cfg.num_experts // world
    own = slice(rank * e_loc, (rank + 1) * e_loc)
    names = ("we_gate", "we_up", "we_down")
    mesh = make_mesh((1, world), "cuda")

    def run(ep):
        q = {k: v for k, v in p.items()}
        if ep:  # this rank's expert blocks only, never gathered
            q = {**q, **{n: {"kernel": p[n]["kernel"][own].clone()}
                         for n in names}}
        leaves = [x, q["router"]["kernel"]] + [q[n]["kernel"] for n in names]
        for t in leaves:
            t.requires_grad_()
        if ep:
            with axis_rules(mesh):
                y, aux = mlp_mod.moe_apply(q, cfg, x)
        else:
            y, aux = mlp_mod.moe_apply(q, cfg, x)
        grads = torch.autograd.grad((y * cot).sum() + aux, leaves)
        return y.detach(), aux.detach(), [g.detach() for g in grads]

    def timed(ep):
        times = []
        for _ in range(count):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            run(ep)
            b.record()
            torch.cuda.synchronize(dev)
            times.append(a.elapsed_time(b))
        return sorted(times)[len(times) // 2]

    y0, aux0, g0 = run(False)
    mlp_mod.ALL_TO_ALL.update(forward=0, backward=0)
    y1, aux1, g1 = run(True)
    exchanges = dict(mlp_mod.ALL_TO_ALL)
    g0 = g0[:2] + [g[own] for g in g0[2:]]

    def err(a, b):
        return (float((a - b).abs().max()),
                float((2e-5 + 2e-4 * b.abs()).min()),
                bool(torch.allclose(a, b, rtol=2e-4, atol=2e-5)))

    checks = {"y": err(y1, y0), "aux": err(aux1, aux0)}
    for name, a, b in zip(("x", "router") + names, g1, g0):
        checks[f"grad {name}"] = err(a, b)
    return {"checks": checks, "exchanges": exchanges,
            "ms_local": timed(False), "ms_ep": timed(True)}


def _torchrun(n: int, args, tag: str) -> dict:
    """``python -m torch.distributed.run --standalone --nproc-per-node n -m
    repro_torch.launch.train args``: its output printed, its ``[train]
    result`` line returned (raises on a non-zero exit)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), "-m", "repro_torch.launch.train",
           *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    seconds = time.perf_counter() - t0
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith("[train] result "):
            result = json.loads(line[len("[train] result "):])
        elif not line.startswith("[measured]"):
            say(f"[{tag}] {line}")
    if proc.returncode != 0 or result is None:
        raise AssertionError(f"{tag}: torchrun exited {proc.returncode}:\n"
                             f"{proc.stderr[-6000:]}")
    result["wall_s"] = seconds
    say(f"[{tag}] torchrun with {n} rank(s): {seconds:.3f} s of wall time")
    return result


def multi_device(card: str) -> dict:
    """Phase 21: Qwen1.5-4B at full width cut to 2 layers, batch 4 × 2048
    (two hosts' slices of 2), 3 steps under ``rotor:`` at the midpoint of
    the chain measured here: the plain single-process run; (a) the same
    through ``torchrun --nproc-per-node 1`` on NCCL (world 1: collectives
    that move nothing); (b) ``compressed_psum_mean`` on one step's real
    gradients through NCCL at world 1; (c) two ranks sharing the card over
    gloo at mesh (2, 1), each on its host's slice, writing checkpoints,
    then the expert-parallel MoE block at world 2 against its local path;
    (c) takes the first two steps and checkpoints;
    (d) that checkpoint restored at world 1 takes the third, with (a)'s
    loss.  Returns (a)'s launch counts."""
    import datetime
    import shutil
    from types import SimpleNamespace

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.solver import solve_min_memory
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.compression import (compressed_psum_mean,
                                                     compression_ratio,
                                                     ef_init)
    from repro_torch.distributed.local import free_port, run_local
    from repro_torch.kernels.dp_fill import ops as dp_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.launch.steps import axes_at, measure_chain
    from repro_torch.models.lm import StagedLM
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training
    from repro_torch.tree import leaves_with_paths, tensors_of

    t_phase = time.perf_counter()
    dev = torch.device("cuda")

    cfg = get_config(ARCH, **{k: tuple(v) if isinstance(v, list) else v
                              for k, v in MD_OVERRIDES.items()})
    model = StagedLM(cfg)
    params = model.init(0, dev)
    data = SyntheticLMData(cfg, BATCH, SEQ, host_count=2, hosts=2)
    batch = data.device_batch(0, dev)
    measured = measure_chain(model, params, batch)
    mid = int((solve_min_memory(measured).mem_limit
               + measured.store_all_peak()) / 2)
    n_params = sum(t.numel() for t in tensors_of(params))
    say(f"[multi] {ARCH} cut to {cfg.num_layers} layers: {n_params} "
        f"parameters, d_model {cfg.d_model}, {cfg.n_heads} heads, vocab "
        f"{cfg.vocab_size}; batch {BATCH} × {SEQ} as 2 host slices; rotor at "
        f"the measured chain's midpoint {mid} B on {card}")
    loop = dict(steps=STEPS, global_batch=BATCH, seq_len=SEQ,
                policy=f"rotor:{mid}", solver_impl="cuda", log_every=1)
    plain = run_training(cfg, TrainLoopConfig(**loop, data_hosts_per_process=2),
                         device=dev, params=params, chain=measured,
                         log_fn=lambda *_: None)
    want = plain["losses"]
    say(f"[multi] plain single-process run: losses {want}, step seconds "
        f"{[r['seconds'] for r in plain['steps']]} on {card}")

    common = ["--arch", ARCH, "--override", json.dumps(MD_OVERRIDES),
              "--global-batch", str(BATCH), "--seq-len", str(SEQ),
              "--steps", str(STEPS), "--policy", f"rotor:{mid}",
              "--solver-impl", "cuda"]

    def close(tag, got, ref, rtol=1e-3):
        if len(got) != len(ref) or not np.allclose(got, ref, rtol=rtol,
                                                   atol=0):
            raise AssertionError(f"{tag}: losses {got} against {ref} "
                                 f"(rtol {rtol})")

    # -- (a) world 1 on NCCL through torchrun --------------------------------
    a = _torchrun(1, common + ["--data-hosts-per-process", "2",
                               "--dist-backend", "nccl"], "multi a")
    close("(a)", a["losses"], want)
    for name in (flash_ops.NAME, rms_ops.NAME, dp_ops.NAME):
        if not a["launches"].get(name):
            raise AssertionError(f"(a) never launched {name}")
    say(f"[multi] (a) world 1, NCCL: losses {a['losses']} = the plain run's "
        f"within rtol 1e-3; plan digest {a['plan_digest'][:16]} on its one "
        f"rank; launches {json.dumps(a['launches'])}; step seconds "
        f"{a['step_seconds']}; first step's collectives "
        f"{json.dumps(a['collective_bytes'])} (world 1: they move nothing) "
        f"on {card}")

    # -- (b) compression on one step's real gradients, NCCL at world 1 -------
    leaves = tensors_of(plain["params"])
    loss = model.loss_fn(plain["params"], batch, tree=plain["plan"].tree)
    grads = torch.autograd.grad(loss, leaves)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mean, err = compressed_psum_mean(grads, ef_init(grads),
                                         dist.group.WORLD, 1)
        torch.cuda.synchronize()
        worst, worst_ratio = 0.0, 0.0
        for g, m, e in zip(grads, mean, err):
            scale = float(g.float().abs().max()) / 127.0
            dev_ = float((m.float() - g.float()).abs().max())
            worst = max(worst, dev_)
            worst_ratio = max(worst_ratio, dev_ / max(scale, 1e-12))
        if worst_ratio > 1.0:
            raise AssertionError(f"(b) a compressed mean off its plain mean "
                                 f"by {worst_ratio:.4f} of its scale")
        say(f"[multi] (b) compressed_psum_mean on {len(grads)} real "
            f"gradients ({sum(g.numel() for g in grads)} values), NCCL at "
            f"world 1: largest |mean - plain mean| {worst:.6e}, "
            f"{worst_ratio:.4f} of its tensor's scale (≤ 1 held); "
            f"compression_ratio {compression_ratio()} (int8 against bf16) on "
            f"{card}")
    finally:
        dist.destroy_process_group()
    del grads, mean, err, loss, leaves
    torch.cuda.empty_cache()

    # -- (c) two ranks sharing the card over gloo at mesh (2, 1) ------------
    ck = ROOT / "build" / "ckpt_multi"
    shutil.rmtree(ck, ignore_errors=True)
    # (c) takes the first STEPS - 1 steps and checkpoints after the last
    common[common.index("--steps") + 1] = str(STEPS - 1)
    c = _torchrun(2, common + ["--dist-backend", "gloo", "--ckpt-dir",
                               str(ck), "--ckpt-every", "0"], "multi c")
    close("(c)", c["losses"], a["losses"][:STEPS - 1])
    mesh = SimpleNamespace(shape={"data": 2, "model": 1})
    axes = model.param_axes()
    with shd.axis_rules(mesh):
        expect = sum(t.numel() * t.element_size() // shd.shard_factor(
            *axes_at(axes, k), shape=t.shape)
            for k, t in leaves_with_paths(model.init(device="meta")))
    if c["param_bytes_local"] != expect:
        raise AssertionError(f"(c) rank 0 holds {c['param_bytes_local']} B "
                             f"of parameters, not {expect}")
    comm = c["collective_bytes"]
    say(f"[multi] (c) world 2 over gloo at mesh (2, 1): losses "
        f"{c['losses']} = (a)'s on the same global batch within rtol 1e-3; "
        f"rank 0 holds {c['param_bytes_local']} B of the "
        f"{sum(t.numel() * t.element_size() for t in tensors_of(params))} B "
        f"of parameters (= Σ bytes / shard factor); step seconds "
        f"{c['step_seconds']}; collective bytes of the first step "
        f"{sum(comm['bytes'].values())} ({json.dumps(comm)}) on {card}")
    ep = run_local(_ep_rank, 2, (0, 5), timeout=300.0)
    for r, res in enumerate(ep):
        bad = [k for k, v in res["checks"].items() if not v[2]]
        if bad or res["exchanges"] != {"forward": 2, "backward": 2}:
            raise AssertionError(f"(c) EP rank {r}: {bad} off the local "
                                 f"path, exchanges {res['exchanges']}")
    say(f"[multi] (c) expert parallelism, {EP_ARCH} MoE block at full width "
        f"(batch {EP_BATCH} × {SEQ}, float32), world 2 over gloo, mesh (1, 2): output, aux and "
        f"gradients equal the local path's within rtol 2e-4 / atol 2e-5 "
        f"(max |Δ|: " + ", ".join(
            f"{k} {v[0]:.3e}" for k, v in ep[0]["checks"].items())
        + f"); exchanges {json.dumps(ep[0]['exchanges'])}; forward + "
        f"backward {ep[0]['ms_ep']:.4f} ms EP against {ep[0]['ms_local']:.4f} "
        f"ms local (rank 0, CUDA events, median of 5) on {card}")

    # -- (d) (c)'s checkpoint restored at world 1 ----------------------------
    d = run_training(cfg, TrainLoopConfig(**loop, data_hosts_per_process=2,
                                          ckpt_dir=str(ck), ckpt_every=0),
                     device=dev, chain=measured, log_fn=lambda *_: None)
    if d["start_step"] != STEPS - 1:
        raise AssertionError(f"(d) resumed at step {d['start_step']}")
    close("(d)", d["losses"], a["losses"][STEPS - 1:])
    shutil.rmtree(ck, ignore_errors=True)
    say(f"[multi] (d) world 2's step-{STEPS - 2} checkpoint restored "
        f"at world 1: step {STEPS - 1} loss {d['losses']} = the "
        f"uninterrupted run's {a['losses'][STEPS - 1:]} within rtol 1e-3")
    say(f"[multi] phase 21: {time.perf_counter() - t_phase:.3f} s on {card}")
    summary = {"losses": want, "predicted": plain["plan"].peak_device_mem,
               "fwd_bwd": [r["fwd_bwd_peak_bytes"] for r in plain["steps"]]}
    del plain, d, params, measured
    torch.cuda.empty_cache()
    return a["launches"], summary



# -- phase 22: model-axis tensor parallelism and serving on a mesh -------------

TP = 2          # the model axis: two ranks sharing the card over gloo
# Zamba2-2.7B at full width cut to its first 2 layers: one chunk, opening
# with the shared attention block
TP_ZAMBA_OVERRIDES = {"num_layers": 2, "layer_kinds": ["zamba"] * 2,
                      "use_flash_attention": True, "use_ssd_kernel": True}
# Qwen1.5-4B at full width cut to 4 layers, served at batch 8 × 2048
TP_SERVE_OVERRIDES = {"num_layers": 4, "layer_kinds": ["dense"] * 4,
                      "n_chunks": 4, "use_flash_attention": True}
TP_NEW = 8      # new tokens of the served batch (prefill's + 7 decode steps)


def _config(arch, overrides):
    from repro_torch.configs import get_config

    return get_config(arch, **{k: tuple(v) if isinstance(v, list) else v
                               for k, v in overrides.items()})


class _KernelShapes:
    """While active, the q shape of every K3 launch and the x shape of
    every K6 launch (the wrappers' kernel entry points, wrapped)."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.kernels.ssd import ops as ssd_ops

        self.seen = {"flash": set(), "ssd": set()}
        self.saved = (flash_ops.attention_fwd, ssd_ops.ssd_chunk_blocks)
        fa, sc = self.saved

        def flash(q, k, v):
            if q.is_cuda:
                self.seen["flash"].add(tuple(q.shape))
            return fa(q, k, v)

        def ssd(x, *rest):
            if x.is_cuda:
                self.seen["ssd"].add(tuple(x.shape))
            return sc(x, *rest)

        flash_ops.attention_fwd, ssd_ops.ssd_chunk_blocks = flash, ssd
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.kernels.ssd import ops as ssd_ops

        flash_ops.attention_fwd, ssd_ops.ssd_chunk_blocks = self.saved
        return False


def _tp_train_rank(rank, world, arch, overrides, rotor):
    """One rank of a tensor-parallel training run at mesh (1, world) on the
    card: 3 steps of ``run_training(mesh=)``, the kernels' launches and
    shapes counted (store-all without ``rotor``).  With ``rotor`` a first
    one-step run under ``rotor:x1`` has ``run_training`` measure the chain
    on the split stages (every rank in lockstep, rank 0's sent to all), and
    the 3 steps run on that chain under ``rotor:`` at its midpoint.  The
    solver cache is this process's memory, so the plan's fill launches."""
    os.environ["REPRO_STORE"] = "memory://"
    import torch

    from repro_torch import counters
    from repro_torch.core.solver import solve_min_memory
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.lm import StagedLM
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = _config(arch, overrides)
    mesh = shd.make_mesh((1, world), "cuda")

    def train(steps, policy, chain=None):
        return run_training(cfg, TrainLoopConfig(
            steps=steps, global_batch=BATCH, seq_len=SEQ, policy=policy,
            solver_impl="cuda", log_every=1, data_hosts_per_process=2),
            device=dev, params=StagedLM(cfg).init(0, dev), chain=chain,
            mesh=mesh, log_fn=lambda *_: None)

    chain, policy, budget, first = None, "none", None, None
    t0 = time.perf_counter()
    if rotor:
        first = train(1, "rotor:x1")
        chain = first["chain"]
        low = solve_min_memory(chain, impl="plain", cache=False).mem_limit
        budget = int((low + chain.store_all_peak()) / 2)
        policy = f"rotor:{budget}"
        first = {"loss": first["losses"][0], "digest": first["plan_digest"]}
        torch.cuda.empty_cache()
    measured_s = time.perf_counter() - t0
    counters.reset()
    with _KernelShapes() as shapes:
        out = train(STEPS, policy, chain)
    return {"losses": out["losses"], "digest": out["plan_digest"],
            "launches": counters.snapshot(), "shapes": shapes.seen,
            "predicted": (out["plan"].peak_device_mem if out["plan"]
                          is not None else None),
            "fwd_bwd": [r["fwd_bwd_peak_bytes"] for r in out["steps"]],
            "seconds": [r["seconds"] for r in out["steps"]],
            "comm": out["collective_bytes"], "budget": budget,
            "first": first, "chain": None if chain is None else {
                "floor": float(low), "store_all": float(
                    chain.store_all_peak())},
            "measured_s": measured_s,
            "param_bytes_local": out["param_bytes_local"]}


def _teacher_forced(model, params, prompts, tokens, max_len, prefill=None,
                    step=None):
    """The first two sequences' logits (2, n, V) float32 on the host:
    prefill's last position, then one decode step per column of
    ``tokens`` but the last, each fed that column (the reference's
    greedy tokens)."""
    import torch

    prefill = prefill or (lambda p, b, m: model.prefill(p, b, max_len=m))
    step = step or model.decode_step
    logits, cache = prefill(params, {"tokens": torch.as_tensor(
        prompts, device="cuda")}, max_len)
    seen = [logits[:2, 0].float().cpu()]
    for i in range(tokens.shape[1] - 1):
        logits, cache = step(params, cache, torch.as_tensor(
            tokens[:, i:i + 1], device="cuda"))
        seen.append(logits[:2, 0].float().cpu())
    del logits, cache
    return torch.stack(seen, 1)


def _tp_serve_rank(rank, world, prompts, tokens):
    """One rank of serving on the mesh (1, world) under ``DECODE_RULES``:
    ``run_serving(mesh=)`` (greedy tokens, this rank's cache bytes), then
    the same prefill and decode steps fed ``tokens`` (the single-process
    run's), keeping the first two sequences' logits."""
    import torch

    from repro_torch import counters
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          serving_params)
    from repro_torch.models.lm import StagedLM
    from repro_torch.runtime.serve_loop import ServeLoopConfig, run_serving

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = _config(ARCH, TP_SERVE_OVERRIDES)
    mesh = shd.make_mesh((1, world), "cuda")
    model = StagedLM(cfg)
    params = model.init(0, dev)
    max_len = SERVE_PROMPT + TP_NEW
    counters.reset()
    shd.reset_collectives()
    with _KernelShapes() as shapes:
        served = run_serving(cfg, params, prompts, ServeLoopConfig(
            max_new_tokens=TP_NEW, max_len=max_len), model=model,
            device=dev, mesh=mesh, rules=shd.DECODE_RULES)
    launches, comm = counters.snapshot(), shd.collectives()
    local = serving_params(model, params, mesh)
    del params
    seen = _teacher_forced(model, local, prompts, tokens, max_len,
                           make_prefill_step(model, mesh, shd.DECODE_RULES),
                           make_serve_step(model, mesh, shd.DECODE_RULES))
    return {"generations": served["generations"],
            "kv_bytes_local": served["kv_bytes_local"],
            "prefill_s": served["prefill_s"],
            "decode_tokens_per_s": served["decode_tokens_per_s"],
            "seen": seen.numpy(), "launches": launches, "comm": comm,
            "shapes": shapes.seen}


def tensor_parallel(card: str, plain21: dict) -> dict:
    """Phase 22: model-axis tensor parallelism and serving on a mesh, two
    ranks sharing the card over gloo at mesh (1, 2).  (a) Qwen1.5-4B at
    full width, 2 layers, batch 4 × 2048, 3 steps under ``rotor:`` at the
    midpoint of the chain measured on the split stages: losses equal phase
    21's plain run (rtol 2e-3), the plan digests agree, K3 runs on each
    rank's 10 heads, K4 and a DP fill launch, and each rank's
    forward+backward activation peak, predicted / measured, lies in [1,
    1.25].  (b) Zamba2-2.7B at full width, its first 2 layers, 3 steps:
    losses equal the single-process run's (rtol 2e-3), K6 on 40 SSM heads
    and K3 on 16 heads of 80 per rank.  (c) Qwen1.5-4B at full width, 4
    layers, served at batch 8 × 2048 for 8 new tokens under
    ``DECODE_RULES``: each rank's cache is half the whole one, and fed the
    single-process tokens the mesh decode's logits lie within phase 15's
    bf16 tolerance of the single-process decode's (max |Δ| ≤ 0.5, mean ≤
    0.01 beyond the floor, the same decode on the plain versions).
    (a') is (a) through the launcher under ``torchrun --nproc-per-node 2``
    with ``--model-parallel 2 --dist-backend gloo`` at (a)'s budget: losses
    against phase 21's, K3, K4 and a DP fill launched on rank 0.
    Returns each part's launches, summed over the ranks."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.distributed.local import run_local
    from repro_torch.kernels.dp_fill import ops as dp_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models.lm import StagedLM
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    launches = {}

    def summed(ranks):
        out = {}
        for r in ranks:
            for k, n in r["launches"].items():
                out[k] = out.get(k, 0) + n
        return out

    def close(tag, got, ref, rtol=2e-3):
        if len(got) != len(ref) or not np.allclose(got, ref, rtol=rtol,
                                                   atol=0):
            raise AssertionError(f"{tag}: losses {got} against {ref} "
                                 f"(rtol {rtol})")

    def comm_line(comm):
        return (f"first step's collectives {sum(comm['bytes'].values())} B: "
                + ", ".join(f"{k} {comm['bytes'][k]} B ({comm['calls'][k]} "
                            f"calls)" for k in sorted(comm['calls'])))

    # -- (a) Qwen1.5-4B, rotor on the chain measured on the split stages -----
    t0 = time.perf_counter()
    qa = run_local(_tp_train_rank, TP, (ARCH, MD_OVERRIDES, True),
                   timeout=600.0)
    qcfg = _config(ARCH, MD_OVERRIDES)
    want_q = (BATCH, SEQ, qcfg.n_heads // TP, qcfg.head_dim)
    for r, res in enumerate(qa):
        close(f"(a) rank {r}", res["losses"], plain21["losses"])
        close(f"(a) rank {r}'s first run", [res["first"]["loss"]],
              plain21["losses"][:1])
        for name in (flash_ops.NAME, rms_ops.NAME, dp_ops.NAME):
            if not res["launches"].get(name):
                raise AssertionError(f"(a) rank {r} never launched {name}")
        if res["shapes"]["flash"] != {want_q}:
            raise AssertionError(f"(a) rank {r}: K3 ran at "
                                 f"{res['shapes']['flash']}, not {want_q}")
        ratios = [res["predicted"] / fb for fb in res["fwd_bwd"]]
        say(f"[tp] (a) rank {r}: losses {res['losses']}; the first run "
            f"(run_training measuring the chain on the split stages in "
            f"lockstep, then one step at rotor:x1, loss "
            f"{res['first']['loss']}, digest {res['first']['digest'][:16]}) "
            f"{res['measured_s']:.3f} s; floor {res['chain']['floor']:.6e} B, store-all "
            f"{res['chain']['store_all']:.6e} B, rotor at {res['budget']} B; "
            f"activation peak over the forward and backward predicted "
            f"{res['predicted']:.6e} B, measured {res['fwd_bwd']} B "
            f"(predicted / measured {[round(x, 4) for x in ratios]}); the "
            f"single-process run (phase 21, same batch, its own midpoint): "
            f"predicted {plain21['predicted']:.6e} B, measured "
            f"{plain21['fwd_bwd']} B; step seconds {res['seconds']}; "
            f"{res['param_bytes_local']} B of parameters held; K3 at "
            f"{sorted(res['shapes']['flash'])}; launches "
            f"{json.dumps(res['launches'])}; {comm_line(res['comm'])} on "
            f"{card}")
        if not all(1.0 <= x <= 1.25 for x in ratios):
            raise AssertionError(f"(a) rank {r}: predicted / measured "
                                 f"activation peak {ratios} outside [1, 1.25]")
    if len({r["digest"] for r in qa}) != 1:
        raise AssertionError(f"(a) the ranks planned differently: "
                             f"{[r['digest'][:16] for r in qa]}")
    if len({r["first"]["digest"] for r in qa}) != 1:
        raise AssertionError("(a) the ranks' first runs planned differently")
    launches["tp_qwen"] = summed(qa)
    say(f"[tp] (a) {ARCH} at full width, {qcfg.num_layers} layers, batch "
        f"{BATCH} × {SEQ}, mesh (1, {TP}) over gloo on one card: losses "
        f"{qa[0]['losses']} = phase 21's plain run {plain21['losses']} "
        f"within rtol 2e-3; one plan (digest {qa[0]['digest'][:16]}); "
        f"{time.perf_counter() - t0:.3f} s on {card}")

    # -- (a') the same through the launcher under torchrun --------------------
    ta = _torchrun(TP, [
        "--arch", ARCH, "--override", json.dumps(MD_OVERRIDES),
        "--global-batch", str(BATCH), "--seq-len", str(SEQ), "--steps",
        str(STEPS), "--policy", f"rotor:{qa[0]['budget']}", "--solver-impl",
        "cuda", "--model-parallel", str(TP), "--dist-backend", "gloo",
        "--data-hosts-per-process", "2"], "tp a'")
    close("(a')", ta["losses"], plain21["losses"])
    for name in (flash_ops.NAME, rms_ops.NAME, dp_ops.NAME):
        if not ta["launches"].get(name):
            raise AssertionError(f"(a') rank 0 never launched {name}")
    if not ta["collective_bytes"]["calls"].get("tp_all_reduce"):
        raise AssertionError("(a') the blocks did not run tensor-parallel")
    launches["tp_launcher"] = ta["launches"]
    say(f"[tp] (a') the launcher under torchrun, --model-parallel {TP} "
        f"--dist-backend gloo --policy rotor:{qa[0]['budget']} (the chain "
        f"measured by run_training on the split stages): losses "
        f"{ta['losses']} = phase 21's plain run within rtol 2e-3; plan digest "
        f"{ta['plan_digest'][:16]}; rank 0's launches "
        f"{json.dumps(ta['launches'])}; step seconds {ta['step_seconds']}; "
        f"{comm_line(ta['collective_bytes'])} on {card}")

    # -- (b) Zamba2-2.7B, its first 2 layers ---------------------------------
    t0 = time.perf_counter()
    zcfg2 = _config(ZAMBA_ARCH, TP_ZAMBA_OVERRIDES)
    zmodel = StagedLM(zcfg2)
    zplain = run_training(zcfg2, TrainLoopConfig(
        steps=STEPS, global_batch=BATCH, seq_len=SEQ, policy="none",
        log_every=1, data_hosts_per_process=2), device=dev,
        params=zmodel.init(0, dev), log_fn=lambda *_: None)
    zwant = zplain["losses"]
    zsteps = [r["seconds"] for r in zplain["steps"]]
    del zplain
    torch.cuda.empty_cache()
    zb = run_local(_tp_train_rank, TP, (ZAMBA_ARCH, TP_ZAMBA_OVERRIDES,
                                        False), timeout=600.0)
    heads = zcfg2.ssm_expand * zcfg2.d_model // zcfg2.ssm_head_dim // TP
    want_x = (BATCH, SEQ, heads, zcfg2.ssm_head_dim)
    want_zq = (BATCH, SEQ, zcfg2.n_heads // TP, zcfg2.head_dim)
    for r, res in enumerate(zb):
        close(f"(b) rank {r}", res["losses"], zwant)
        if res["shapes"]["ssd"] != {want_x} or res["shapes"]["flash"] != {
                want_zq}:
            raise AssertionError(f"(b) rank {r}: K6 at {res['shapes']['ssd']}"
                                 f", K3 at {res['shapes']['flash']}; wanted "
                                 f"{want_x} and {want_zq}")
        for name in (flash_ops.NAME, rms_ops.NAME, ssd_ops.NAME):
            if not res["launches"].get(name):
                raise AssertionError(f"(b) rank {r} never launched {name}")
        say(f"[tp] (b) rank {r}: losses {res['losses']}; K6 at "
            f"{sorted(res['shapes']['ssd'])}, K3 at "
            f"{sorted(res['shapes']['flash'])}; step seconds "
            f"{res['seconds']}; launches {json.dumps(res['launches'])}; "
            f"{comm_line(res['comm'])} on {card}")
    launches["tp_zamba"] = summed(zb)
    say(f"[tp] (b) {ZAMBA_ARCH} at full width, its first "
        f"{zcfg2.num_layers} layers (one shared block), store-all: losses "
        f"{zb[0]['losses']} = the single-process run's {zwant} within rtol "
        f"2e-3 (its steps {zsteps} s); "
        f"{time.perf_counter() - t0:.3f} s on {card}")

    # -- (c) serving Qwen1.5-4B on the mesh ----------------------------------
    t0 = time.perf_counter()
    scfg = _config(ARCH, TP_SERVE_OVERRIDES)
    smodel = StagedLM(scfg)
    sparams = smodel.init(0, dev)
    prompts = np.random.default_rng(22).integers(
        0, scfg.vocab_size, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    max_len = SERVE_PROMPT + TP_NEW
    tokens, seen, _, _ = uncounted(lambda: decode_run(
        "tp serve (single process)", smodel, sparams, {"tokens": prompts},
        TP_NEW - 1, max_len, card))
    plain = StagedLM(dataclasses.replace(scfg, use_flash_attention=False))
    floor_seen = _teacher_forced(plain, sparams, prompts, tokens, max_len)
    floor = float((floor_seen - seen.cpu()).abs().mean())
    whole = smodel.cache_layout(SERVE_BATCH, max_len).allocated_bytes - 4
    del sparams, floor_seen
    torch.cuda.empty_cache()
    sc = run_local(_tp_serve_rank, TP, (prompts, tokens), timeout=600.0)
    ref = seen.cpu().numpy()
    for r, res in enumerate(sc):
        err = np.abs(res["seen"] - ref)
        worst, mean = float(err.max()), float(err.mean())
        agree = float((res["generations"] == tokens).mean())
        say(f"[tp] (c) rank {r}: cache {res['kv_bytes_local']} B of the "
            f"whole {whole} B; fed the single-process tokens, logits "
            f"against its decode's: max |Δ| {worst:.4f} (tol "
            f"{SERVE_MAX_ERR}), mean |Δ| {mean:.6f} (tol {SERVE_MEAN_ERR} + "
            f"the floor {floor:.6f}, its decode on the plain versions); "
            f"greedy tokens equal to the single-process run's: {agree:.4f} "
            f"of {tokens.size}; prefill {res['prefill_s']:.3f} s, decode "
            f"{res['decode_tokens_per_s']:.1f} tokens/s; K3 at "
            f"{sorted(res['shapes']['flash'])}; launches "
            f"{json.dumps(res['launches'])}; collectives "
            f"{json.dumps(res['comm'])} on {card}")
        if 2 * res["kv_bytes_local"] != whole:
            raise AssertionError(f"(c) rank {r} holds {res['kv_bytes_local']}"
                                 f" B of the cache, not half of {whole}")
        if not (worst <= SERVE_MAX_ERR and mean <= SERVE_MEAN_ERR + floor):
            raise AssertionError(f"(c) rank {r}: the mesh decode differs "
                                 f"from the single-process one")
    launches["tp_serve"] = summed(sc)
    say(f"[tp] (c) {ARCH} at full width, {scfg.num_layers} layers, batch "
        f"{SERVE_BATCH} × {SERVE_PROMPT} + {TP_NEW} tokens, DECODE_RULES at "
        f"mesh (1, {TP}): {time.perf_counter() - t0:.3f} s on {card}")
    say(f"[tp] phase 22: {time.perf_counter() - t_phase:.3f} s on {card}")
    return launches


# Phase 23: the counted FLOPs of the Qwen step (FlopCounterMode + K3's
# analytic FLOPs per launch) over train_terms' count at mesh 1 on the plan's
# schedule must fall in this window, stated before the first card run from
# the same count on fake CPU tensors (tests/test_torch_roofline.py): 0.968
# store-all, 0.948 at a rotor midpoint of the analytic chain.  Below 1:
# each layer's replay stops before its last matrix product (the
# checkpoint's early stop), the analytic count replays the head too, and
# K3 computes only the causal half of its scores.
FLOP_RATIO_WINDOW = (0.93, 0.98)
# decode of phase 23: cache length and new tokens (the prompt fills the rest)
ROOF_CACHE, ROOF_NEW = 2048, 16


def roofline(card: str, chain) -> dict:
    """Phase 23: the roofline on the card.  (a) ``H100_SXM.hbm_bytes``
    against the card's memory; (b) Qwen1.5-4B at 8 layers, batch 4 × 2048,
    rotor at ``chain``'s midpoint (path 6's measured chain): one step
    counted (``FlopCounterMode`` + K3's FLOPs per launch) against
    ``train_terms``, the median of 3 more steps beside its terms, the
    step's share of its bound and MFU; (c) Qwen1.5-4B at 40 layers decoding
    batch 8 on a 2048-position cache, the median step beside
    ``decode_terms``; (d) ``python -m repro_torch.launch.dryrun --arch
    qwen1.5-4b --shape train_4k`` at 256 fake ranks with the card hidden:
    exit 0, ``fits``.  A share above 1.05 fails: the formula would count
    work the step does not do.  Returns the launch counts of (b) and
    (c)."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import counters
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core.solver import solve_min_memory
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.analytic import decode_terms, train_terms
    from repro_torch.launch.mesh import H100_SXM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.flops import model_flops_per_step
    from repro_torch.models.lm import StagedLM
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.plan import resolve_policy
    from repro_torch.tree import tensors_of

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    launches = {}

    def bound_of(terms):
        return max(terms[k] for k in ("compute_s", "memory_s",
                                      "collective_s"))

    # (a) the hardware the terms are priced on
    props = torch.cuda.get_device_properties(0)
    say(f"[roofline] (a) {props.name}: total_memory {props.total_memory} B, "
        f"{props.multi_processor_count} SMs; H100_SXM.hbm_bytes "
        f"{H100_SXM.hbm_bytes} B, peak {H100_SXM.peak_bf16:.6e} FLOP/s bf16, "
        f"HBM {H100_SXM.hbm_bw:.6e} B/s, NVLink {H100_SXM.nvlink_bw:.6e} "
        f"B/s, network {H100_SXM.network_bw:.6e} B/s on {card}")
    if props.total_memory != H100_SXM.hbm_bytes:
        raise AssertionError(f"H100_SXM.hbm_bytes {H100_SXM.hbm_bytes} B is "
                             f"not the card's {props.total_memory} B")

    # (b) the training step against its analytic terms
    cfg = get_config(ARCH, num_layers=LAYERS, layer_kinds=("dense",) * LAYERS,
                     n_chunks=LAYERS, use_flash_attention=True)
    model = StagedLM(cfg)
    mid = (solve_min_memory(chain).mem_limit + chain.store_all_peak()) / 2
    counters.reset()
    plan = resolve_policy(f"rotor:{int(mid)}", chain, impl="cuda")
    params = model.init(0, dev)
    opt = adamw_init(tensors_of(params))
    batch = SyntheticLMData(cfg, BATCH, SEQ, seed=0).device_batch(0, dev)
    step = make_train_step(model, AdamWConfig(), plan.tree)
    k3_before = counters.snapshot().get(flash_ops.NAME, 0)
    with FlopCounterMode(display=False) as fc:
        loss0 = float(step(params, opt, batch, 0)["loss"])
    torch.cuda.synchronize()
    k3 = counters.snapshot().get(flash_ops.NAME, 0) - k3_before
    k3_flops = k3 * flash_ops.kernel_flops(BATCH, SEQ, cfg.n_heads,
                                           cfg.head_dim)
    counted = fc.get_total_flops() + k3_flops
    times, losses = [], [loss0]
    for i in range(1, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(params, opt, batch, i)["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches["roofline_train"] = counters.snapshot()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"roofline (b): non-finite loss {losses}")
    terms = train_terms(cfg, ShapeSpec("train", "train", SEQ, BATCH), None,
                        model, chain, plan.schedule)
    ratio = counted / terms["flops_per_device"]
    step_s = statistics.median(times)
    share = bound_of(terms) / step_s
    mf = model_flops_per_step(cfg, BATCH, SEQ)
    mfu = mf / (step_s * H100_SXM.peak_bf16)
    # N counts the embedding table, which a lookup reads and does no FLOPs
    # on; the second MFU leaves its V·d out (the head stays in)
    mf_work = mf - 6.0 * cfg.vocab_size * cfg.d_model * BATCH * SEQ
    mfu_work = mf_work / (step_s * H100_SXM.peak_bf16)
    say(f"[roofline] (b) {ARCH} at {LAYERS} layers, batch {BATCH} x {SEQ}, "
        f"rotor:{int(mid)} (ops {json.dumps(plan.op_counts())}) on path 6's "
        f"measured chain: counted {counted:.6e} FLOP ({fc.get_total_flops():.6e} "
        f"by FlopCounterMode + {k3} K3 launches x "
        f"{flash_ops.kernel_flops(BATCH, SEQ, cfg.n_heads, cfg.head_dim)}), "
        f"train_terms {terms['flops_per_device']:.6e} FLOP: ratio "
        f"{ratio:.6f} (window {FLOP_RATIO_WINDOW}; below 1: each layer's "
        f"replay stops before its last matrix product, the analytic count "
        f"replays the head, K3 computes the causal half) on {card}")
    say(f"[roofline] (b) step seconds {times} (median {step_s:.6f}); terms "
        f"compute {terms['compute_s']:.6e} s, memory {terms['memory_s']:.6e} "
        f"s, collective {terms['collective_s']:.6e} s; share of the bound "
        f"(max term / step) {share:.6f}; model FLOPs {mf:.6e} (6 N D, N = "
        f"{mf / 6 / (BATCH * SEQ):.0f}, the embedding table included), "
        f"MFU {mfu:.6f}; without the table (N = "
        f"{mf_work / 6 / (BATCH * SEQ):.0f}) MFU {mfu_work:.6f}; against "
        f"{H100_SXM.peak_bf16:.3e} FLOP/s; losses {losses} on {card}")
    if not FLOP_RATIO_WINDOW[0] <= ratio <= FLOP_RATIO_WINDOW[1]:
        raise AssertionError(f"roofline (b): counted / analytic FLOPs "
                             f"{ratio:.6f} outside {FLOP_RATIO_WINDOW}")
    if share > 1.05:
        raise AssertionError(f"roofline (b): the step takes {step_s:.6f} s, "
                             f"below its analytic bound {bound_of(terms):.6f}"
                             f" s (share {share:.4f} > 1.05)")
    del params, opt, batch, step, plan
    torch.cuda.empty_cache()

    # (c) whole-cache decode against decode_terms
    dcfg = get_config(ARCH, use_flash_attention=True)
    dmodel = StagedLM(dcfg)
    dparams = dmodel.init(0, dev)
    B = SERVE_BATCH
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, dcfg.vocab_size, (B, ROOF_CACHE - ROOF_NEW)).astype(np.int32)
    ).to(dev)
    counters.reset()
    with torch.no_grad():
        logits, cache = dmodel.prefill(dparams, {"tokens": prompt},
                                       max_len=ROOF_CACHE)
        tok = torch.argmax(logits[:, -1], dim=-1)
        dtimes = []
        for _ in range(ROOF_NEW - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = dmodel.decode_step(dparams, cache, tok[:, None])
            tok = torch.argmax(logits[:, -1], dim=-1)
            torch.cuda.synchronize()
            dtimes.append(time.perf_counter() - t0)
    launches["roofline_decode"] = counters.snapshot()
    if not torch.isfinite(logits).all():
        raise AssertionError("roofline (c): non-finite decode logits")
    dterms = decode_terms(dcfg, ShapeSpec("decode", "decode", ROOF_CACHE, B),
                          None, dmodel)
    dstep = statistics.median(dtimes)
    dshare = bound_of(dterms) / dstep
    say(f"[roofline] (c) {ARCH} at {dcfg.num_layers} layers, batch {B}, "
        f"cache {ROOF_CACHE} (prompt {ROOF_CACHE - ROOF_NEW}, "
        f"{ROOF_NEW - 1} decode steps): median step {dstep:.6f} s "
        f"({B / dstep:.2f} tokens/s; steps {dtimes}); decode_terms memory "
        f"{dterms['memory_s']:.6e} s ({dterms['hbm_bytes_per_device']:.6e} "
        f"B), compute {dterms['compute_s']:.6e} s; share of the bound "
        f"{dshare:.6f}; the bound's rate {B / bound_of(dterms):.2f} tokens/s "
        f"on {card}")
    if dshare > 1.05:
        raise AssertionError(f"roofline (c): the decode step takes "
                             f"{dstep:.6f} s, below its analytic bound "
                             f"(share {dshare:.4f} > 1.05)")
    del dparams, cache, logits
    torch.cuda.empty_cache()

    # (d) the dry-run at 256 fake ranks, the card hidden
    out_dir = ROOT / "build" / "dryrun"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", "train_4k", "--out", str(out_dir)],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES=""))
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith("[dryrun]"):
            say(line)
    if proc.returncode:
        raise AssertionError(f"roofline (d): the dry-run exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    rec = json.loads((out_dir / f"{ARCH}__train_4k__32x8.json").read_text())
    an, roof = rec["analytic"], rec["roofline"]
    say(f"[roofline] (d) dry-run {ARCH} x train_4k at {rec['n_devices']} "
        f"fake ranks, mesh {rec['mesh']}: exit 0 in {wall:.1f} s, trace_s "
        f"{rec['trace_s']:.1f}; fits {rec['fits']} (tracked peak "
        f"{rec['memory']['peak_bytes']:.6e} B, plan "
        f"{rec['model_memory']['total_bytes']:.6e} B, of "
        f"{rec['memory']['hbm_bytes']} B); analytic compute "
        f"{an['compute_s']:.6e} s, memory {an['memory_s']:.6e} s, collective "
        f"{an['collective_s']:.6e} s ({an['dominant']}); traced compute "
        f"{roof['compute_s']:.6e} s, memory {roof['memory_s']:.6e} s, "
        f"collective {roof['collective_s']:.6e} s ({roof['dominant']}), "
        f"useful ratio {roof['useful_ratio']:.6f} (host CPU, fake tensors)")
    if not rec["fits"]:
        raise AssertionError("roofline (d): qwen1.5-4b x train_4k does not "
                             "fit one device of the production mesh")
    say(f"[roofline] phase 23: {time.perf_counter() - t_phase:.3f} s on "
        f"{card}")
    return launches


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the solver cache, plan store and frontiers of this run (and of its
    # child processes) live under build/, emptied first: no run reads an
    # earlier run's entries
    store_dir = ROOT / "build" / "store"
    import shutil
    shutil.rmtree(store_dir, ignore_errors=True)
    os.environ["REPRO_STORE"] = f"file://{store_dir}"

    from repro_torch import counters
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec, input_specs
    from repro_torch.core import dp_kernels
    from repro_torch.core.baselines import best_periodic
    from repro_torch.core.chain import Chain, HostTransferModel
    from repro_torch.configs import paper_resnet
    from repro_torch.core.planner import (chain_backward_transients,
                                          measure_host_bandwidth,
                                          profile_stages_measured,
                                          time_stages_in_chain)
    from repro_torch.core.solver import solve_min_memory, solve_optimal
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import _build
    from repro_torch.kernels.dp_fill import ops as dp_ops
    from repro_torch.kernels.dp_fill import ref as dp_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.launch import train
    from repro_torch.launch.steps import (in_chain_lines, measure_chain,
                                          plan_chain, plan_training)
    from repro_torch.launch.tradeoff import BUDGETS as TRADEOFF_BUDGETS
    from repro_torch.launch.tradeoff import run_lm_tradeoff, run_tradeoff
    from repro_torch.models.lm import StagedLM
    from repro_torch.offload.executor import execute_offload_schedule
    from repro_torch.offload.solver import (solve_min_device_memory,
                                            solve_optimal_offload)
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs.drift import compare
    from repro_torch.obs.trace import (Tracer, transfer_overlap,
                                       validate_trace_file)
    from repro_torch.offload.host_buffer import HostBuffer
    from repro_torch.optim.adamw import global_norm
    from repro_torch.plan import DEFAULT_NUM_SLOTS, resolve_policy
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training
    from repro_torch.tree import tensors_of

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- 1. environment ----------------------------------------------------
    card = card_name()
    say(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    say(f"[env] nvidia-smi: {card}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    say(f"[build] nvcc {json.dumps({k: round(v, 2) for k, v in built.items()})}"
        f" wall {time.perf_counter() - t0:.2f}s -> {_build.BUILD_DIR}")
    for name in _build.SOURCES:
        log = _build.library_path(name).with_name(
            _build.library_path(name).name + ".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build] {name}: {line.strip()}")

    # -- 2b. the static gate ------------------------------------------------
    static_gate(card)

    # -- 3. host link ----------------------------------------------------------
    def config_of(arch, overrides, **more):
        """``get_config`` with the launcher's JSON overrides (lists as
        tuples, as ``launch.train`` reads them)."""
        return get_config(arch, **{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in overrides.items()}, **more)

    cfg = config_of(ARCH, OVERRIDES)
    zcfg = config_of(ZAMBA_ARCH, ZAMBA_OVERRIDES)
    ecfg = config_of(MOE_ARCH, MOE_OVERRIDES)
    dcfg = config_of(MLA_ARCH, MLA_OVERRIDES)
    vcfg = config_of(VLM_ARCH, FLASH_ON)
    acfg = config_of(AUDIO_ARCH, FLASH_ON)
    model = StagedLM(cfg)
    specs = input_specs(cfg, ShapeSpec("train", "train", SEQ, BATCH))
    nbytes_act = BATCH * SEQ * cfg.d_model * 2   # one bf16 boundary activation
    link = measure_host_bandwidth(nbytes_act, repeats=20, device=dev)
    d2h, h2d = link.bandwidth_d2h, link.bandwidth_h2d
    d2h_ms, h2d_ms = nbytes_act / d2h * 1e3, nbytes_act / h2d * 1e3
    bw = min(d2h, h2d)
    say(f"[link] pinned copies of {nbytes_act} B (median of 20): device->host "
        f"{d2h_ms:.4f} ms = {d2h:.6e} B/s, host->device {h2d_ms:.4f} ms = "
        f"{h2d:.6e} B/s; the host tier is priced at {bw:.6e} B/s on {card}")
    host = HostTransferModel(bandwidth_d2h=bw)

    # -- 4. kernel vs plain -----------------------------------------------------
    def planes(d, ns, w):
        r = torch.rand((d, ns, w), generator=gen, device=dev) * 8
        r[torch.rand((d, ns, w), generator=gen, device=dev) < 0.3] = math.inf
        lm = torch.rand((d, ns, w), generator=gen, device=dev) * 8 - 4
        return r, lm

    def offload_planes(d, ns, w):
        r, lmb = planes(d, ns, w)
        r3, lme = planes(d, ns, w)
        lmb3 = torch.rand((d, ns, w), generator=gen, device=dev) * 8 - 4
        toff = torch.rand((ns, 1), generator=gen, device=dev) * 6
        return r, r3, lmb, lme, lmb3, toff

    dp_err = 0.0
    for shape in ((3, 5, 17), (9, 2, 501)):
        r, lm = planes(*shape)
        got, want = (dp_ops.band_min_two_tier(r, lm),
                     dp_ref.band_min_two_tier(r, lm))
        if not torch.equal(got, want):
            raise AssertionError(f"dp band-min differs from plain at {shape}")
        diff = torch.where(got == want, 0.0, (got - want).abs())
        dp_err = max(dp_err, float(diff.max()))
    say("[check] dp_band_min_two_tier == plain (torch.equal) at (3,5,17), "
        "(9,2,501)")
    for shape in ((3, 5, 17), (9, 2, 501)):
        ops5 = offload_planes(*shape)
        for a, b in zip(dp_ops.band_min_offload(*ops5),
                        dp_ref.band_min_offload(*ops5)):
            if not torch.equal(a, b):
                raise AssertionError(f"dp band-min offload differs from "
                                     f"plain at {shape}")
    say("[check] dp_band_min_offload == plain (torch.equal, all three "
        "minima) at (3,5,17), (9,2,501)")

    def fills_agree(dch, S, what, falls=(True,)):
        """K1/K2 tables (two-tier) and K5a/K5b tables (offload) against the
        numpy banded fills of the same discretized chain."""
        for fall in falls:
            kw = dict(allow_fall=fall)
            want = dp_kernels.fill_tables(dch, S, impl="banded", **kw).data
            for impl in ("cuda", "cuda_fused"):
                if not np.array_equal(dp_kernels.fill_tables(
                        dch, S, impl=impl, **kw).data, want):
                    raise AssertionError(f"{what}: two-tier {impl} table "
                                         f"differs from the banded fill "
                                         f"(allow_fall={fall})")
            tb, te = dp_kernels.fill_tables_offload(dch, S, impl="banded",
                                                    **kw)
            for impl in ("cuda", "cuda_fused"):
                gb, ge = dp_kernels.fill_tables_offload(dch, S, impl=impl,
                                                        **kw)
                if not (np.array_equal(gb.data, tb.data)
                        and np.array_equal(ge.data, te.data)):
                    raise AssertionError(f"{what}: offload {impl} tables "
                                         f"differ from the banded fill "
                                         f"(allow_fall={fall})")

    rng = np.random.default_rng(0)
    for i in range(8):
        L = int(rng.integers(1, 13)) if i < 6 else (40, 64)[i - 6]
        wa = rng.integers(1, 4, L + 1)
        if i in (5, 7):
            wa[L // 2] = 10_000        # wider than the budget: C3 gathers
        ch = Chain.make(uf=rng.integers(1, 5, L + 1),
                        ub=rng.integers(1, 5, L + 1), wa=wa,
                        wabar=rng.integers(1, 6, L + 1),
                        of=rng.integers(0, 2, L + 1),
                        ob=rng.integers(0, 2, L + 1),
                        host=None if i == 4 else HostTransferModel(
                            bandwidth_d2h=float(rng.choice([0.5, 1.0, 4.0])),
                            latency=float(rng.choice([0.0, 0.25]))))
        m = math.ceil(Chain.make(uf=ch.uf, ub=ch.ub, wa=np.minimum(wa, 4),
                                 wabar=ch.wabar).store_all_peak() * 0.6)
        fills_agree(ch.discretize(m, int(m)), int(m), f"random chain {i}",
                    (True, False))
    say("[check] K1/K2 and K5a/K5b fills == banded (np.array_equal), "
        "allow_fall on and off, on 8 random integer chains (6 of L 1..12, "
        "one of 40 and one of 64 stages; one without a host tier, two with "
        "an activation wider than the budget, where C3 gathers)")

    n = 8192
    a, b = randn(n, n, dtype=torch.bfloat16), randn(n, n, dtype=torch.bfloat16)
    peak_flops = 2 * n ** 3 / (median_ms(lambda: a @ b, reps=10) * 1e-3)
    del a, b
    say(f"[env] measured bf16 matmul rate {peak_flops:.6e} FLOP/s "
        f"({n}^3) on {card}")
    chain = plan_chain(model, specs, peak_flops)
    hchain = chain.with_host(host)
    low = solve_min_memory(chain).mem_limit
    high = chain.store_all_peak()
    budget = (low + high) / 2
    low3 = solve_min_device_memory(hchain).mem_limit
    budget_off = (low3 + low) / 2
    S500 = DEFAULT_NUM_SLOTS
    dchain = chain.discretize(budget, S500)
    tab_cuda = dp_kernels.fill_tables(dchain, S500, impl="cuda")
    tab_np = dp_kernels.fill_tables(dchain, S500, impl="banded")
    if not np.array_equal(tab_cuda.data, tab_np.data):
        raise AssertionError("CUDA DP table differs from the banded fill")
    say(f"[check] DP table of the card chain (L={chain.length}, "
        f"S={S500}, budget {budget:.6e} B): cuda == banded")
    # the chain users plan: the same model at its published depth, one layer
    # a chunk, profiled on meta tensors (no weights are allocated)
    full_cfg = get_config(ARCH, n_chunks=get_config(ARCH).num_layers,
                          use_flash_attention=True)
    full_chain = plan_chain(StagedLM(full_cfg), input_specs(
        full_cfg, ShapeSpec("train", "train", SEQ, BATCH)), peak_flops)
    full_hchain = full_chain.with_host(host)
    full_low = solve_min_memory(full_chain).mem_limit
    full_budgets = ((full_low + full_chain.store_all_peak()) / 2,
                    (solve_min_device_memory(full_hchain).mem_limit
                     + full_low) / 2)
    # one host-tier chain at its offload budget per length: the operands on
    # which K2 and K5b are checked against their plain versions and timed
    # and the two-tier chain at its midpoint budget per length, on which K1
    # is checked and timed as the per-band fill calls it
    fused_chains, two_tier_chains = {}, {}
    for ch, hch, budgets in ((chain, hchain, (budget, budget_off)),
                             (full_chain, full_hchain, full_budgets)):
        for b_, what in zip(budgets, ("midpoint", "offload")):
            fills_agree(ch.discretize(b_, S500), S500,
                        f"L={ch.length} chain, {what} budget, no host tier",
                        (True, False))
            fills_agree(hch.discretize(b_, S500), S500,
                        f"L={ch.length} chain, {what} budget, host tier",
                        (True, False))
        say(f"[check] Qwen1.5-4B chain L={ch.length} (S={S500}) at budgets "
            f"{budgets[0]:.6e} and {budgets[1]:.6e} B, host tier on and off, "
            f"allow_fall on and off: cuda and cuda_fused tables == banded "
            f"(np.array_equal)")
        fused_chains[ch.length] = hch.discretize(budgets[1], S500)
        two_tier_chains[ch.length] = ch.discretize(budgets[0], S500)

    def table_operands(dch, c3="chain"):
        """K1's and K5a's operands as the per-band fill of ``dch`` keeps
        them on the card: random tables of its shapes (``+inf`` in 30 % of
        the right-child cells), its own vectors, its C3 case (or ``c3``) and
        band widths: (tables, (wa, cum, toff), c3, widths)."""
        v = dp_kernels._views(dch)
        L, S1 = dch.length, S500 + 1
        ctx = dp_kernels._FillCtx(v, L, S500)
        if c3 == "chain":
            h = dch.chain.host
            c3 = None if h is None or not h.enabled else (
                "slice" if ctx.wa_uncapped else "gather")
        ncells = (L + 1) * (L + 2) // 2

        def table(width, lo, hi, p_inf=0.0):
            t = torch.rand((ncells, width), generator=gen, device=dev)
            t = t * (hi - lo) + lo
            t[torch.rand(t.shape, generator=gen, device=dev) < p_inf] = \
                math.inf
            return t

        cb = table(S1 + 1, 0, 8, 0.3)
        cb[:, 0] = math.inf                     # the sentinel column
        tables = (table(S1 + (ctx.wcap if c3 == "slice" else 0), 0, 8, 0.3),
                  table(S1, -4, 4), table(S1, -4, 4), table(S1, -4, 4), cb)
        wa = np.minimum(ctx.WA, S1) if c3 == "slice" else ctx.WA
        vecs = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (wa.astype(np.int32), ctx.CUM32,
                               dp_kernels.offload_vectors(dch, v)[0]))
        caps = dp_kernels.saturation_caps(v, S500)
        return (tables, vecs, c3,
                [dp_kernels.band_width(caps, d, S500) for d in range(1, L + 1)])

    def table_bands(kind, tables, vecs, c3, L):
        """K1 (``kind`` "two-tier") or K5a bound to resident tables, as the
        per-band fill binds it once per fill (its output buffer too)."""
        out = torch.empty(3 * L * (S500 + 1), device=dev)
        if kind == "two-tier":
            return dp_ops.TableBands(tables[0], tables[1:2], out, L=L)
        wa, cum, toff = vecs
        return dp_ops.TableBands(tables[0], tables[1:4], out, L=L, S=S500,
                                 c3=c3, cb=tables[4], wa=wa, cum=cum,
                                 toff=toff)

    for L_ in sorted(fused_chains):
        cases = [("two-tier", table_operands(two_tier_chains[L_])),
                 ("offload", table_operands(fused_chains[L_]))]
        cases += [("offload", table_operands(fused_chains[L_], c3))
                  for c3 in (None, "slice", "gather")
                  if c3 != cases[1][1][2]]
        for kind, (tables, vecs, c3, widths) in cases:
            bands = table_bands(kind, tables, vecs, c3, L_)
            for d, W in enumerate(widths, 1):
                n = bands.launch(d, W)
                if not torch.equal(bands.out[:n],
                                   bands.plain(d, W).reshape(-1)):
                    raise AssertionError(f"{kind} band-min on resident "
                                         f"tables differs from plain at "
                                         f"L={L_}, d={d}, c3={c3}")
        say(f"[check] K1 and K5a (no host tier, C3 by slice and by gather; "
            f"the chain's own: {cases[1][1][2]}) on resident tables == their "
            f"plain versions (torch.equal), every band of the L={L_} chain "
            f"at its widths")
        # the tables would stay on the card and count in the training
        # paths' measured activation peaks
        del cases, bands, tables, vecs

    def fused_operands(hd):
        """K2's and K5b's operands on the card: (t0, two-tier vectors,
        offload vectors, keywords, FusedOperands)."""
        fo = dp_ops.FusedOperands(hd, S500, True)
        toff_np, tpre_np = dp_kernels.offload_vectors(hd, fo.v)
        return (fo.initial(fo.base_table(), dev), fo.tensors(dev),
                fo.tensors(dev, toff_np, tpre_np),
                dict(L=fo.L, W=fo.W, allow_fall=True), fo)

    for hd in fused_chains.values():
        t0, ints2, ints5, fkw, fused = fused_operands(hd)
        if not torch.equal(dp_ops.fused_fill_two_tier(t0, *ints2, **fkw),
                           dp_ref.fused_fill_two_tier(t0, *ints2, **fkw)):
            raise AssertionError(f"K2 differs from its plain version at "
                                 f"L={fused.L}")
        for host_on in (True, False):
            got = dp_ops.fused_fill_offload(t0, t0, *ints5, host_on=host_on,
                                            **fkw)
            want = dp_ref.fused_fill_offload(t0, t0, *ints5, host_on=host_on,
                                             **fkw)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"K5b (host_on={host_on}) differs from "
                                     f"its plain version at L={fused.L}")
        say(f"[check] K2 and K5b (host tier on and off) == their plain "
            f"versions on the same CUDA tensors (torch.equal), L={fused.L} "
            f"chain, ({fused.ncells}, {fused.W}) tables")

    def check_close(name, got, want, tol):
        err = (got.float() - want.float()).abs()
        lim = tol + tol * want.float().abs()
        if not bool(torch.all(err <= lim)):
            raise AssertionError(f"{name}: max |err| {float(err.max())} "
                                 f"above {tol}")
        return float(err.max())

    flash_err = {}
    # small shapes, then the paths' own: Qwen, the Zamba2 shared block
    # (32 heads × 80), the MoE path's attention (16 heads × 128),
    # PaliGemma's text-only prefill (batch 8, 8 heads × 256 on one KV head)
    # and MusicGen's (24 heads × 64)
    path_shapes = [(BATCH, SEQ, c.n_heads, c.n_kv_heads, c.head_dim)
                   for c in (cfg, zcfg, ecfg)]
    path_shapes += [(SERVE_BATCH, SERVE_PROMPT, vcfg.n_heads,
                     vcfg.n_kv_heads, vcfg.head_dim),
                    (BATCH, SEQ, acfg.n_heads, acfg.n_kv_heads,
                     acfg.head_dim)]
    # phase 22's per-rank shapes at model axis 2: Qwen's 10 heads of 128,
    # the Zamba2 shared block's 16 of 80
    path_shapes += [(BATCH, SEQ, c.n_heads // TP, c.n_kv_heads // TP,
                     c.head_dim) for c in (cfg, zcfg)]
    for (B, S, H, K, D) in ((2, 200, 8, 2, 16), (1, 300, 4, 1, 64),
                            (2, 333, 8, 2, 80), (2, 333, 8, 1, 256),
                            (1, 1000, 4, 2, 256), *path_shapes):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            q, k, v = (randn(B, S, h, D, dtype=dtype) for h in (H, K, K))
            err = check_close(f"flash {B, S, H, K, D} {dtype}",
                              flash_ops.attention_fwd(q, k, v),
                              flash_ref.attention(q, k, v), tol)
            flash_err[(B, S, H, K, D, dtype)] = err
            say(f"[check] flash_attention_fwd {(B, S, H, K, D)} {dtype}: "
                f"max |err| {err:.3e} (tol {tol})")
            del q, k, v
        # the kernel rounds o once on the store, and each p <= 1 to bf16
        # before P·V (as the plain version rounds the probabilities), a
        # relative error of at most 2^-8: hold it to the float32 plain
        # version of the same bf16 inputs within 2 bf16 ulps + 2^-8 Σp|v|/l
        # (+1e-5 near zero), Σp|v|/l being the plain attention of |v|
        full = (B, S, H, K, D) == (BATCH, SEQ, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim)
        for seed in (1, 2, 3) if full else (1,):
            g = torch.Generator(device=dev).manual_seed(seed)
            q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev)
                       .to(torch.bfloat16) for h in (H, K, K))
            got = flash_ops.attention_fwd(q, k, v).float()
            q, k, v = q.float(), k.float(), v.float()
            want = flash_ref.attention(q, k, v)
            gap = (got - want).abs()
            lim = (2 * bf16_ulp(want) + 2.0 ** -8
                   * flash_ref.attention(q, k, v.abs()) + 1e-5)
            if not bool(torch.all(gap <= lim)):
                raise AssertionError(
                    f"flash {B, S, H, K, D} bf16 seed {seed}: |err| vs "
                    f"float32 exceeds 2 bf16 ulps + 2^-8 Σp|v|/l + 1e-5 by "
                    f"{float((gap - lim).max())}")
            say(f"[check] flash_attention_fwd {(B, S, H, K, D)} bf16 seed "
                f"{seed} vs float32 plain: max |err| {float(gap.max()):.3e}, "
                f"largest |err| / tol {float((gap / lim).max()):.4f} (tol 2 "
                f"bf16 ulp + 2^-8 Σp|v|/l + 1e-5)")
            del q, k, v, got, want, gap, lim

    # the bf16 path at every head dim is the tensor-core kernel: each
    # instantiation of flash_fwd_sm90 in the built library holds HGMMA
    sass = sass_functions("flash_attn_fwd", "flash_fwd_sm90")
    dims = sorted(int(name.split("ILi")[1].split("E")[0]) for name in sass)
    if dims != sorted(flash_ops.HEAD_DIMS) or not all(
            "HGMMA" in body for body in sass.values()):
        raise AssertionError(f"flash_fwd_sm90 instantiations {dims}: not "
                             f"every head dim on wgmma")
    say(f"[check] flash_fwd_sm90 (bf16) at head dims {dims}: every "
        f"instantiation runs HGMMA (wgmma), cuobjdump -sass")

    # RMSNorm at the paths' widths (Qwen's and Zamba2's 2560; Mamba's and
    # the MoE path's 2048; the gated norms of Mamba 4096 and Zamba2 5120)
    # and a ragged width on an offset base (the scalar tail loop)
    rows = BATCH * SEQ
    rms_err = {}
    for d, offset in ((cfg.d_model, 0), (2048, 0), (4096, 0), (5120, 0),
                      (1000, 1)):
        for dt in (torch.bfloat16, torch.float32):
            x = randn(rows, d + offset, dtype=dt)[:, offset:]
            s = (1 + 0.1 * randn(d)).to(dt)
            got = rms_ops.rms_norm_fwd(x, s)
            want = rms_ref.rms_norm(x, s)
            err = float((got.float() - want.float()).abs().max())
            if dt == torch.bfloat16:
                if not bool(torch.all((got.float() - want.float()).abs()
                                      <= bf16_ulp(want))):
                    raise AssertionError(f"rms_norm ({rows}, {d}) bf16 "
                                         f"differs by more than one ulp")
                rms_err[d] = err
            else:
                torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
            say(f"[check] rms_norm ({rows}, {d}){' offset base' * offset} "
                f"{dt}: max |err| {err:.3e} "
                f"({'1 bf16 ulp' if dt == torch.bfloat16 else 'rtol 1e-6'})")
            del x, s, got, want

    mcfg = config_of(MAMBA_ARCH, MAMBA_OVERRIDES)
    Hs = mcfg.ssm_expand * mcfg.d_model // mcfg.ssm_head_dim
    P, N, G, Q = (mcfg.ssm_head_dim, mcfg.ssm_state, mcfg.ssm_groups,
                  mcfg.ssm_chunk)

    zHs = zcfg.ssm_expand * zcfg.d_model // zcfg.ssm_head_dim
    zN, zG = zcfg.ssm_state, zcfg.ssm_groups
    if (zcfg.ssm_head_dim, zcfg.ssm_chunk) != (P, Q):
        raise AssertionError("the Zamba2 path's SSD head dim or chunk is not "
                             "the Mamba path's")

    def ssd_inputs(B, S, H, G, dtype, N=N):
        """The mixer's ranges: dt = softplus(·) · 0.1, A from -1 to -16."""
        dt = F.softplus(randn(B, S, H)) * 0.1
        A = -torch.exp(torch.linspace(0.0, math.log(16.0), H, device=dev))
        return (randn(B, S, H, P, dtype=dtype), dt, A,
                0.3 * randn(B, S, G, N, dtype=dtype),
                0.3 * randn(B, S, G, N, dtype=dtype))

    def ssd_kind(dtype, H, G, N=N):
        slice_ = ssd_ops.head_slice(dtype, P, N, Q, H, G)
        if dtype == torch.bfloat16 and not slice_:
            raise AssertionError(f"bf16 at (P, N, Q) = {(P, N, Q)}, {H} "
                                 f"heads in {G} groups: the scalar kernel")
        return (f"tensor-core kernel, slices of {slice_} heads" if slice_
                else "scalar kernel")

    ssd_err = {}
    # the Mamba path's shape, a ragged sequence, heads that share a group,
    # and a group of 12 heads: a slice of 8 and a ragged slice of 4 on the
    # bf16 tensor-core kernel; then the Zamba2 path's shape, state 64 (in
    # bf16 the tensor-core kernel too, 80 heads in slices of 8)
    for (B, S, H, G_, N_) in ((BATCH, SEQ, Hs, G, N), (2, 1000, 8, G, N),
                              (1, 512, 8, 4, N), (1, 512, 12, 1, N),
                              (BATCH, SEQ, zHs, zG, zN),
                              (BATCH, SEQ, zHs // TP, zG, zN)):
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, A, Bm, Cm = ssd_inputs(B, S, H, G_, dtype, N_)
            xp, dtp, Bp, Cp = ssd_ref.pad_to_chunks(Q, x, dt, Bm, Cm)
            got = ssd_ops.ssd_chunk_blocks(xp, dtp, A, Bp, Cp, Q)
            want = ssd_ref.chunk_terms(xp.float(), dtp, A, Bp.float(),
                                       Cp.float(), Q)
            what = f"ssd_chunk {(B, S, H, P, G_, N_, Q)} {dtype}"
            err = max(check_close(f"{what} {part}", a_, b_, 2e-4)
                      for part, a_, b_ in zip(("y_diag", "states"), got,
                                              want))
            del got, want
            (y, st), (wy, wst) = (ssd_ops.ssd_chunked(x, dt, A, Bm, Cm, Q),
                                  ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, Q))
            check_close(f"{what} final state", st, wst, 2e-4)
            if not (y.shape == wy.shape and bool(torch.isfinite(y).all())):
                raise AssertionError(f"{what}: scan output {tuple(y.shape)}")
            ssd_err[(B, S, H, G_, dtype)] = err
            say(f"[check] {what} ({ssd_kind(dtype, H, G_, N_)}): kernel vs "
                f"plain max |err| {err:.3e} "
                f"(tol 2e-4 rtol+atol, plain in f32 on the same values); "
                f"whole scan's final state within 2e-4")
            del x, dt, A, Bm, Cm, xp, dtp, Bp, Cp, y, st, wy, wst
    # the Mamba and Zamba2 paths' layout: x, B and C are strided views into
    # the mixer's one (B, S, d_inner + 2·G·N) tensor, split as the mixer
    # splits it (phase 22's split mixer: its heads' x beside B and C)
    for H_, G_, N_ in ((Hs, G, N), (zHs, zG, zN), (zHs // TP, zG, zN)):
        d_inner = H_ * P
        for dtype in (torch.float32, torch.bfloat16):
            xbc = randn(BATCH, SEQ, d_inner + 2 * G_ * N_, dtype=dtype)
            xbc[..., d_inner:] *= 0.3
            x, Bm, Cm = torch.split(xbc, [d_inner, G_ * N_, G_ * N_], dim=-1)
            x = x.reshape(BATCH, SEQ, H_, P)
            Bm, Cm = (t.reshape(BATCH, SEQ, G_, N_) for t in (Bm, Cm))
            dt = F.softplus(randn(BATCH, SEQ, H_)) * 0.1
            A = -torch.exp(torch.linspace(0.0, math.log(16.0), H_,
                                          device=dev))
            what = (f"ssd_chunk {(BATCH, SEQ, H_, P, G_, N_, Q)} {dtype} as "
                    f"strided views into the mixer's xBC")
            err = max(check_close(f"{what} {part}", a_, b_, 2e-4)
                      for part, a_, b_ in zip(
                          ("y_diag", "states"),
                          ssd_ops.ssd_chunk_blocks(x, dt, A, Bm, Cm, Q),
                          ssd_ref.chunk_terms(x.float(), dt, A, Bm.float(),
                                              Cm.float(), Q)))
            say(f"[check] {what} ({ssd_kind(dtype, H_, G_, N_)}, row stride "
                f"{x.stride(1)}): kernel vs plain max |err| {err:.3e} (tol "
                f"2e-4 rtol+atol, plain in f32 on the same values)")
            del xbc, x, Bm, Cm, dt, A
    torch.cuda.empty_cache()

    # -- 5. timing at the main path's shapes -------------------------------------
    kernels = []

    def k5a_bytes(c3, wa, L, d, w):
        """The bytes K5a's band d must move, each input read once and each
        output written once: for split j and row r, w columns of Lmb and
        Lme (and Lmb3 with C3), and R's row once over the columns read,
        [0, w) and by slice also [wa[r], wa[r] + w); by gather the bare
        table's row over the columns gathered, and the vectors read."""
        ns = L + 1 - d
        cells, planes = d * ns, (2 if c3 is None else 3)
        n = (planes + 1) * cells * w + planes * ns * w     # + outputs
        if c3 == "slice":
            n += d * int(np.minimum(wa[:ns], w).sum()) + 2 * ns  # wa, toff
        elif c3 == "gather":
            j, r = np.arange(d)[:, None], np.arange(ns)[None, :]
            wp, wr = wa[1 + j + r], wa[r]

            def col(c):
                return np.clip(np.maximum(c - wp, -(1 << 30)) + wr, -1,
                               S500)

            n += int((col(w - 1) - col(0) + 1).sum())
            n += (L + 1) + L + ns            # wa, CUM, toff
        return 4 * n

    # K1 and K5a as the per-band fills call them: one launch per band on
    # tables kept on the card, into a buffer held for the fill; the library
    # call is the plain version's own expression on planes stacked before
    # the timing (each allocates its output).  The card chain's fill is the
    # row, the full-depth chain's under other_shapes.
    band_min_rows = {dp_ops.NAME: [], dp_ops.NAME_OFFLOAD: []}
    for L_ in sorted(fused_chains):
        for name, kind, dch in (
                (dp_ops.NAME, "two-tier", two_tier_chains[L_]),
                (dp_ops.NAME_OFFLOAD, "offload", fused_chains[L_])):
            tables, vecs, c3, widths = table_operands(dch)
            bands = table_bands(kind, tables, vecs, c3, L_)
            wa_np = vecs[0].cpu().numpy().astype(np.int64)
            times, nbytes, ops = {}, 0.0, 0.0
            for d, w in enumerate(widths, 1):
                ns = L_ + 1 - d
                run = (lambda d=d, w=w: bands.launch(d, w))
                plain = (lambda d=d, w=w: bands.plain(d, w))
                if kind == "two-tier":
                    right, left = dp_ref.band_rows(L_, d, dev)
                    rs, ls = tables[0][right, :w], tables[1][left, :w]
                    library = (lambda rs=rs, ls=ls: torch.amin(rs + ls, 0))
                    nbytes += 4 * (2 * d + 1) * ns * w
                    ops += 2 * d * ns * w
                else:
                    r, r3, lmb, lme, lmb3 = dp_ref.offload_planes(
                        *tables, *vecs[:2], L=L_, S=S500, d=d, W=w, c3=c3)
                    toff = vecs[2][:ns, None]
                    library = (lambda r=r, r3=r3, lmb=lmb, lme=lme,
                               lmb3=lmb3, toff=toff: (
                                   torch.amin(r + lmb, 0),
                                   torch.amin(r + lme, 0),
                                   torch.amin(torch.maximum(r3, toff)
                                              + lmb3, 0)))
                    nbytes += k5a_bytes(c3, wa_np, L_, d, w)
                    ops += (4 if c3 is None else 7 + (c3 == "gather")) \
                        * d * ns * w
                times = add_times(times, {**both_ms(run, plain, library),
                                          "host_ms": host_ms(run)})
            b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
            band_min_rows[name].append({
                **times, "bound_ms": b_ms, "bound_by": b_by,
                "max_abs_err": 0.0,
                "shape": f"one {kind} fill, L={L_}: {L_} bands of "
                         f"{'two' if kind == 'two-tier' else 'five'} "
                         f"(d, L+1-d, W <= {max(widths)}) planes read in "
                         f"place{'' if c3 is None else f', C3 by {c3}'}"})
            del tables, vecs, bands
    for name, line in ((dp_ops.NAME, 86), (dp_ops.NAME_OFFLOAD, 142)):
        main_row, *others = band_min_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dp_band_min.cu",
            "replaces": f"src/repro/kernels/dp_fill/kernel.py:{line}",
            **main_row, "other_shapes": others})
    kernels[0]["max_abs_err"] = dp_err

    # K2 and K5b: one whole fill, staged tensors in place, at the main path's
    # chain (its row) and at the full-depth chain (its other shape)
    fused_rows = {dp_ops.NAME_FUSED: [], dp_ops.NAME_FUSED_OFFLOAD: []}
    for hd in fused_chains.values():
        t0, ints2, ints5, fkw, fused = fused_operands(hd)
        L_ = fused.L
        bands = [(d, L_ + 1 - d) for d in range(1, L_ + 1)]
        cells_w = fused.ncells * fused.W
        n_ops2 = sum(ns * fused.W * (2 * d + 5) for d, ns in bands)
        n_ops5 = sum(ns * fused.W * (8 * d + 10) for d, ns in bands)
        for name, nb, op, run, plain in (
                (dp_ops.NAME_FUSED, 4 * 2 * cells_w, n_ops2,
                 lambda: dp_ops.fused_fill_two_tier(t0, *ints2, **fkw),
                 lambda: dp_ref.fused_fill_two_tier(t0, *ints2, **fkw)),
                (dp_ops.NAME_FUSED_OFFLOAD, 4 * 4 * cells_w, n_ops5,
                 lambda: dp_ops.fused_fill_offload(t0, t0, *ints5,
                                                   host_on=True, **fkw),
                 lambda: dp_ref.fused_fill_offload(t0, t0, *ints5,
                                                   host_on=True, **fkw))):
            b_ms, b_by = bound(nb, op, F32_FLOPS)
            fused_rows[name].append({
                # no single PyTorch call runs a DP recursion: no library call
                **both_ms(run, plain), "host_ms": host_ms(run),
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0,
                "shape": f"one fill, L={L_}: ({fused.ncells}, {fused.W}) f32 "
                         f"tables, {L_} bands"})
        del t0, ints2, ints5
    for name, line in ((dp_ops.NAME_FUSED, 285),
                       (dp_ops.NAME_FUSED_OFFLOAD, 439)):
        main_row, *others = fused_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dp_fused_fill.cu",
            "replaces": f"src/repro/kernels/dp_fill/kernel.py:{line}",
            **main_row, "other_shapes": others})

    time_fills({L_: (two_tier_chains[L_], fused_chains[L_])
                for L_ in sorted(fused_chains)}, card)

    # where the per-band cuda fill's host time goes at L = 41: the _Uplink
    # steps and the launch call timed from outside; the host recursion is
    # the rest
    L_ = full_chain.length
    steps = (("upload", dp_ops._Uplink, "publish"),
             ("kernel", dp_ops.TableBands, "launch"),
             ("download", dp_ops._Uplink, "fetch"))
    originals = [(cls, attr, getattr(cls, attr)) for _, cls, attr in steps]
    spent = {}

    def timed(key, fn):
        def call(*args):
            t_0 = time.perf_counter()
            result = fn(*args)
            spent[key] += time.perf_counter() - t_0
            return result
        return call

    try:
        for (key, cls, attr), (_, _, fn) in zip(steps, originals):
            setattr(cls, attr, timed(key, fn))
        for kind, fill, dch in (
                ("two-tier", dp_ops.fill_two_tier, two_tier_chains[L_]),
                ("offload", dp_ops.fill_offload, fused_chains[L_])):
            runs = []
            for _ in range(11):
                spent.update(upload=0.0, kernel=0.0, download=0.0)
                t_0 = time.perf_counter()
                fill(dch, S500, device=dev)
                one = dict(spent, fill=time.perf_counter() - t_0)
                one["host recursion"] = one["fill"] - sum(spent.values())
                runs.append(one)
            parts = {k: statistics.median(r[k] for r in runs[1:]) * 1e3
                     for k in runs[0]}
            say(f"[time] breakdown of the cuda {kind} fill at L={L_} "
                f"(S={S500}; host clock, median of 10, ms; upload = staging "
                f"the new rows and queueing their copy, kernel = the launch "
                f"call, download = queueing the copy back, waiting for the "
                f"card and unpacking): "
                + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
                + f" on {card}")
    finally:
        for cls, attr, fn in originals:
            setattr(cls, attr, fn)

    # the host's cost of queueing one band's copies as the cuda fill makes
    # them at L = 41 (band 1's upload: band 0's L + 1 rows of the offload
    # fill's four tables; its three minima back), through the library's
    # cudaMemcpyAsync and through Tensor.copy_(non_blocking=True), in turns
    ncells = (L_ + 1) * (L_ + 2) // 2
    link = dp_ops._Uplink([np.zeros((ncells, S500 + 1), np.float32)] * 4,
                          L_, 3, S500 + 1, dev)
    rows_up, n_down = L_ + 1, 3 * L_ * (S500 + 1)
    copies = {
        "upload, library": lambda: link._copy(
            link.buf.data_ptr(), link.stage.data_ptr(),
            rows_up * link.row_bytes),
        "upload, copy_": lambda: link.buf[:rows_up].copy_(
            link.stage[:rows_up], non_blocking=True),
        "download, library": lambda: link._copy(
            link.down.data_ptr(), link.out.data_ptr(), 4 * n_down),
        "download, copy_": lambda: link.down[:n_down].copy_(
            link.out[:n_down], non_blocking=True)}
    spent = {k: [] for k in copies}
    for _ in range(2):
        for k in (*copies, *reversed(copies)):
            spent[k].append(host_ms(copies[k]) * 1e3)
    say(f"[time] host cost of one band's copy at L={L_} (µs, host clock "
        f"behind a sleep kernel, median of 20, four runs each: "
        + "; ".join(f"{k} " + ", ".join(f"{x:.2f}" for x in v)
                    for k, v in spent.items())
        + f") on {card}")
    del link

    # K3 at the paths' shapes: Qwen's (the row of the kernels line), the
    # Zamba2 shared block's, the MoE path's, PaliGemma's and MusicGen's
    flash_rows = []
    for (B, S, H, K, D) in path_shapes:
        q, k, v = (randn(B, S, h, D, dtype=torch.bfloat16) for h in (H, K, K))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flops = 4 * D * (S * (S + 1) // 2) * B * H   # unmasked QK^T and PV
        b_ms, b_by = bound(2 * (2 * B * S * H * D + 2 * B * S * K * D),
                           flops, BF16_TENSOR_FLOPS)
        flash_rows.append({
            **both_ms(lambda: flash_ops.attention_fwd(q, k, v),
                      lambda: flash_ref.attention(q, k, v),
                      lambda: F.scaled_dot_product_attention(
                          qt, kt, vt, is_causal=True, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": flash_err[(B, S, H, K, D, torch.bfloat16)],
            "shape": f"bf16 q ({B},{S},{H},{D}) k,v ({B},{S},{K},{D})"})
        del q, k, v, qt, kt, vt
    kernels.append({
        "name": flash_ops.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attn_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:77",
        **flash_rows[0], "other_shapes": flash_rows[1:]})

    # K4 at Qwen's width (the row of the kernels line), then at the other
    # paths' widths
    rms_rows = []
    for d in (cfg.d_model, 2048, 4096, 5120):
        x = randn(rows, d, dtype=torch.bfloat16)
        s = (1 + 0.1 * randn(d)).to(torch.bfloat16)
        b_ms, b_by = bound(2 * 2 * rows * d + 2 * d, 4 * rows * d, F32_FLOPS)
        rms_rows.append({
            **both_ms(lambda: rms_ops.rms_norm_fwd(x, s),
                      lambda: rms_ref.rms_norm(x, s),
                      lambda: F.rms_norm(x, (d,), s, 1e-6)),
            "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": rms_err[d], "shape": f"bf16 ({rows}, {d})"})
        del x, s
    kernels.append({
        "name": rms_ops.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rms_norm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:24",
        **rms_rows[0], "other_shapes": rms_rows[1:]})

    # K6 at the Mamba path's shape (the row of the kernels line), at the
    # Zamba2 path's (state 64) and at its per-rank 40 heads under phase 22's
    # model axis of 2, all on the tensor-core kernel
    B, S = BATCH, SEQ
    nc = S // Q
    ssd_rows = []
    for H_, G_, N_ in ((Hs, G, N), (zHs, zG, zN), (zHs // TP, zG, zN)):
        x, dt, A, Bm, Cm = ssd_inputs(B, S, H_, G_, torch.bfloat16, N_)
        nbytes = (2 * x.numel() + 4 * dt.numel() + 4 * A.numel()
                  + 2 * (Bm.numel() + Cm.numel())        # inputs, read once
                  + 4 * x.numel() + 4 * B * nc * H_ * P * N_)  # outputs
        causal = Q * (Q + 1) // 2                    # score entries j <= i
        b_ms, b_by = bound(nbytes, B * H_ * nc * (2 * causal * (N_ + P)
                                                  + 2 * Q * P * N_),
                           BF16_TENSOR_FLOPS)
        ssd_rows.append({
            # no PyTorch call computes the SSD within-chunk terms
            **both_ms(lambda: ssd_ops.ssd_chunk_blocks(x, dt, A, Bm, Cm, Q),
                      lambda: ssd_ref.chunk_terms(x, dt, A, Bm, Cm, Q)),
            "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": ssd_err[(B, S, H_, G_, torch.bfloat16)],
            "shape": f"bf16 x ({B},{S},{H_},{P}) B,C ({B},{S},{G_},{N_}), "
                     f"chunk {Q}, {nbytes} B moved, "
                     f"{ssd_kind(torch.bfloat16, H_, G_, N_)}"})
        del x, dt, A, Bm, Cm
    kernels.append({
        "name": ssd_ops.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:55",
        **ssd_rows[0], "other_shapes": ssd_rows[1:]})
    for kern in kernels:
        for row in [kern] + kern.get("other_shapes", []):
            say(f"[time] {kern['name']} {row['shape']}: {row['ms']:.4f} ms, "
                f"plain {row['plain_ms']:.4f} ms, library "
                f"{row['library_ms']} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}); device time {row['device_ms']:.4f} "
                f"ms, plain {row['plain_device_ms']:.4f} ms, library "
                f"{row['library_device_ms']} ms"
                + (f"; host {row['host_ms']:.4f} ms" if "host_ms" in row
                   else "") + f" on {card}")
    say("[time] before the redesigns, quoted (not measured in this run): "
        "the earlier versions as this script timed them on an NVIDIA H100 "
        "80GB HBM3, 700.00 W, one call per event pair: flash_attention_fwd "
        "5.7805 ms, rms_norm 0.0612 ms, ssd_chunk 2.1108 ms (2.2180 ms, "
        "2.1726 ms device time, at Zamba2's state 64 on the scalar "
        "kernel), dp_band_min_two_tier 0.2258 ms against torch.amin "
        "0.2067 ms")
    torch.cuda.empty_cache()

    # -- 6. rotor path ------------------------------------------------------------
    # from here on every plan is verified as it is built, bound or executed
    # (MemoryPlan.verify; a plan that fails raises PlanVerificationError)
    os.environ["REPRO_CHECK"] = "1"
    obs_metrics.reset()
    verified = [0]

    def fresh_metrics():
        """Reset the metrics, keeping the count of verified plans."""
        h = obs_metrics.registry().get("plan.verify_seconds")
        verified[0] += h.count if h is not None else 0
        obs_metrics.reset()
    batch = SyntheticLMData(cfg, BATCH, SEQ, seed=0).device_batch(0, dev)

    def same_results(tag, params, grads_of, model=model, batch=batch):
        """Loss and global gradient norm of ``grads_of`` against store-all
        on one batch, within 1e-2."""
        leaves = tensors_of(params)
        res = {}
        for name, fn in ((tag, grads_of), ("none", None)):
            if fn is None:
                loss = model.loss_fn(params, batch)
                grads = torch.autograd.grad(loss, leaves)
            else:
                loss, grads = fn(params)
            res[name] = (loss.item(), global_norm(grads).item())
            del loss, grads
        for i, what in enumerate(("loss", "grad norm")):
            a_, b_ = res[tag][i], res["none"][i]
            if not abs(a_ - b_) <= 1e-2 * abs(b_):
                raise AssertionError(f"{what}: {tag} {a_} vs store-all {b_}")
        say(f"[same] {tag} vs store-all: loss {res[tag][0]:.6f} / "
            f"{res['none'][0]:.6f}, grad norm {res[tag][1]:.6f} / "
            f"{res['none'][1]:.6f} (rel tol 1e-2)")

    def show_measured(tag, model, params, batch=batch):
        """The chain of ``model`` measured on ``batch``, printed beside the
        analytic chain's times; its sizes must equal the analytic chain's
        with each tensor at the allocator's bound (``allocator=True``)."""
        t0 = time.perf_counter()
        measured = measure_chain(model, params, batch,
                                 log_fn=lambda s_: say(f"{s_} on {card}"))
        say(f"[measured] {tag}: chain L={measured.length} measured in "
            f"{time.perf_counter() - t0:.2f} s (each stage alone: 1 warm-up, "
            f"median of 3, then its times inside the chain) on {card}; "
            f"analytic times at {peak_flops:.6e} FLOP/s")
        analytic = plan_chain(model, input_specs(model.cfg, ShapeSpec(
            "train", "train", SEQ, BATCH)), peak_flops, allocator=True)
        say("[measured] stage: uf s (analytic), ub s (analytic), wa B, "
            "wabar B (each tensor at the allocator's bound), of B, ob B")
        for i in range(measured.length + 1):
            say(f"[measured] {i + 1}: {measured.uf[i]:.6e} "
                f"({analytic.uf[i]:.6e}), {measured.ub[i]:.6e} "
                f"({analytic.ub[i]:.6e}), {int(measured.wa[i])}, "
                f"{int(measured.wabar[i])}, {int(measured.of[i])}, "
                f"{int(measured.ob[i])} on {card}")
        if not (np.array_equal(measured.wa, analytic.wa)
                and np.array_equal(measured.wabar, analytic.wabar)):
            raise AssertionError(
                f"measured sizes differ from the analytic chain's: wa "
                f"{measured.wa} vs {analytic.wa}, wabar {measured.wabar} vs "
                f"{analytic.wabar}")
        say("[measured] wa and wabar == the analytic chain's at the "
            "allocator's bound (np.array_equal)")
        return measured

    def report_steps(tag, plan, steps):
        """Per step, the plan's predicted activation peak over the measured
        one, over the forward and backward and over the whole step; fails
        if the plan under-predicts the forward and backward.  The measured
        forward and backward leaves out the parameter gradients formed by
        each point of it (``core.planner.grad_with_peaks``), as the
        measured chain's ``ob`` does."""
        pred = plan.peak_device_mem
        for i, rec in enumerate(steps):
            fb, whole = rec["fwd_bwd_peak_bytes"], rec["activation_peak_bytes"]
            say(f"[{tag}] step {i}: loss {rec['loss']:.6f}, "
                f"{rec['tokens_per_s']:.1f} tok/s, {rec['seconds']:.4f} s; "
                f"activation peak predicted {pred:.6e} B, measured {fb} B "
                f"over the forward and backward (predicted / measured "
                f"{pred / fb:.4f}), {whole} B over the whole step, the "
                f"optimizer's temporaries included (predicted / measured "
                f"{pred / whole:.4f}) on {card}")
        if not all(math.isfinite(r["loss"]) for r in steps):
            raise AssertionError(f"{tag}: non-finite loss")
        say(f"[{tag}] predicted − measured over the forward and backward: "
            f"{pred - steps[-1]['fwd_bwd_peak_bytes']:.0f} B on {card}")
        ratios = [pred / r["fwd_bwd_peak_bytes"] for r in steps]
        if min(ratios) < 1.0:
            raise AssertionError(
                f"{tag}: the plan under-predicts the forward and backward's "
                f"activation peak (predicted / measured {min(ratios):.4f} "
                f"< 1)")
        if max(ratios) > 1.25:
            raise AssertionError(
                f"{tag}: the plan over-predicts the forward and backward's "
                f"activation peak by more than 25 % (predicted / measured "
                f"{max(ratios):.4f})")

    def trace_report(tag, plan, tracer, name):
        """A traced step's spans: one per schedule op, in order, none
        negative; written as a Perfetto file under build/ and checked with
        ``validate_trace_file``; the drift against the plan printed."""
        spans = tracer.spans
        if [(s_.op, s_.arg) for s_ in spans] != list(plan.schedule.ops):
            raise AssertionError(f"{tag}: {len(spans)} spans for "
                                 f"{len(plan.schedule)} schedule ops")
        if any(not s_.duration >= 0 for s_ in spans):
            raise AssertionError(f"{tag}: a span of negative length")
        path = ROOT / "build" / f"trace_{name}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        tracer.save(str(path))
        if validate_trace_file(str(path)) != len(plan.schedule):
            raise AssertionError(f"{tag}: {path} does not hold one span per "
                                 f"op")
        say(f"[{tag}] traced step: {len(spans)} spans (one per op, CUDA "
            f"events), Perfetto file {path.relative_to(ROOT)} valid; "
            + compare(plan, spans).summary().replace("\n", ";"))

    # the chain the launcher plans on: measured on the card for the same
    # model, seeded weights and first batch (the launcher measures its own)
    params = model.init(0, dev)
    measured = show_measured(f"{ARCH}, per-layer remat (paths 6-8, 10)",
                             model, params)
    del params
    torch.cuda.empty_cache()
    mlow = solve_min_memory(measured).mem_limit
    mhigh = measured.store_all_peak()
    mid = (mlow + mhigh) / 2
    say(f"[rotor] measured chain L={measured.length}: min-memory {mlow:.6e} "
        f"B, store-all {mhigh:.6e} B, budget (midpoint) {int(mid)} B; the "
        f"analytic chain's: {low:.6e} and {high:.6e} B on {card}")
    path_launches = {}
    counters.reset()
    out = train.main([
        "--arch", ARCH, "--override", json.dumps(OVERRIDES),
        "--global-batch", str(BATCH), "--seq-len", str(SEQ),
        "--steps", str(STEPS), "--policy", f"rotor:{int(mid)}",
        "--solver-impl", "cuda"])
    path_launches["rotor"] = counters.snapshot()
    plan = out["plan"]
    if not out["chain"].of.any():
        raise AssertionError("the launcher planned on a chain without "
                             "transients: not the measured chain")
    say(f"[rotor] schedule ops {json.dumps(plan.op_counts())}, predicted "
        f"{plan.expected_time:.6e} s/step on the launcher's measured chain")
    report_steps("rotor", plan, out["steps"])
    launches = path_launches["rotor"]
    say(f"[rotor] launches over the launcher's measurement and {STEPS} "
        f"steps: {launches[dp_ops.NAME]} dp band-min (one plan), "
        f"{launches[flash_ops.NAME]} flash attention, "
        f"{launches[rms_ops.NAME]} rms_norm")

    def rotor_grads(params):
        loss = model.loss_fn(params, batch, tree=plan.tree)
        return loss, torch.autograd.grad(loss, tensors_of(params))

    same_results("rotor", out["params"], rotor_grads)
    rotor_schedule, rotor_chain = plan.schedule.ops, out["chain"]
    del out, plan
    torch.cuda.empty_cache()

    # -- 7. offload path ----------------------------------------------------------
    def moved(p):
        """The boundary activations ``a^i`` (i > 0) the plan ``p`` copies to
        the host: the token batch ``a^0`` alone moves no activation."""
        return [i for k, i in p.schedule.ops if k == "Foff" and i > 0]

    def offload_budget(ch):
        """The offload path's budget on the measured chain ``ch``: between
        its three- and two-tier floors if the three-tier plan there copies
        an activation; else the lowest of 33 budgets from the two-tier floor
        to store-all at which it copies one and is predicted no slower than
        the two-tier plan.  ``None`` if it copies one nowhere."""
        hch = ch.with_host(host)
        low2 = solve_min_memory(ch).mem_limit
        low3 = solve_min_device_memory(hch).mem_limit
        say(f"[offload] measured chain floors: three-tier {low3:.6e} B, "
            f"two-tier {low2:.6e} B ({(low2 - low3) / low2:.4%} apart) on "
            f"{card}")
        b = int((low3 + low2) / 2)
        if not solve_optimal(ch, b).feasible:
            p3 = solve_optimal_offload(hch, b)
            if p3.feasible and moved(p3):
                say(f"[offload] between the floors: budget {b} B, where two "
                    f"tiers do not fit; the plan copies a^{moved(p3)}")
                return b
            offs = ([i for k, i in p3.schedule.ops if k == "Foff"]
                    if p3.feasible else "none: no plan")
            say(f"[offload] between the floors the three-tier plan copies "
                f"no activation (its Foff: {offs})")
        high2 = ch.store_all_peak()
        for k in range(33):
            b = int(low2 + k * (high2 - low2) / 32)
            two, p3 = solve_optimal(ch, b), solve_optimal_offload(hch, b)
            if (two.feasible and p3.feasible and moved(p3)
                    and p3.expected_time <= two.expected_time):
                say(f"[offload] from the two-tier floor up: budget {b} B "
                    f"({k}/32 of the way to store-all), the three-tier plan "
                    f"copies a^{moved(p3)} and is predicted "
                    f"{p3.expected_time:.6e} s against the two-tier "
                    f"{two.expected_time:.6e} s")
                return b
        say("[offload] no budget from the two-tier floor to store-all (33 "
            "tried) at which the three-tier plan copies an activation")
        return None

    off_cfg, off_model, off_chain, off_batch, off_specs = (
        cfg, model, measured, batch, specs)
    off_budget = offload_budget(measured)
    for why, ocfg in (
            ("the same model without per-layer remat, as phase 10's second "
             "trade-off", config_of(ARCH, OVERRIDES, scan_layer_remat="none")),
            (f"{ZAMBA_ARCH} as path 11 runs it, whose chunks' backward, not "
             f"the head's, sets the floor", zcfg)):
        if off_budget is not None:
            break
        say(f"[offload] {off_cfg.name} (scan_layer_remat "
            f"{off_cfg.scan_layer_remat!r}) copies no activation at any "
            f"budget: {why}")
        off_cfg, off_model = ocfg, StagedLM(ocfg)
        off_specs = input_specs(ocfg, ShapeSpec("train", "train", SEQ, BATCH))
        off_batch = SyntheticLMData(ocfg, BATCH, SEQ, seed=0).device_batch(
            0, dev)
        params = off_model.init(0, dev)
        off_chain = show_measured(
            f"{ocfg.name}, scan_layer_remat {ocfg.scan_layer_remat!r} "
            f"(path 7)", off_model, params, off_batch)
        del params
        torch.cuda.empty_cache()
        off_budget = offload_budget(off_chain)
    if off_budget is None:
        raise AssertionError("no model copies a boundary activation to the "
                             "host at any budget")
    # the two-tier plan at the same budget, or at its floor where two tiers
    # do not fit, for the end-to-end comparison (a yardstick run: its
    # launches are not counted on any path)
    two_budget = int(off_budget)
    while not solve_optimal(off_chain, two_budget).feasible:
        two_budget = math.ceil(two_budget * 1.001)
    out = run_training(off_cfg, TrainLoopConfig(
        steps=STEPS, global_batch=BATCH, seq_len=SEQ,
        policy=f"rotor:{two_budget}", solver_impl="cuda", log_every=1),
        device=dev, chain=off_chain, log_fn=say)
    for i, rec in enumerate(out["steps"]):
        say(f"[offload] two-tier yardstick rotor:{two_budget} step "
            f"{i}: {rec['tokens_per_s']:.1f} tok/s, {rec['seconds']:.4f} s, "
            f"measured activation peak {rec['fwd_bwd_peak_bytes']} B over "
            f"the forward and backward on {card}")
    say(f"[offload] two-tier yardstick ops "
        f"{json.dumps(out['plan'].op_counts())}")
    del out
    torch.cuda.empty_cache()
    policy_off = f"optimal_offload:{int(off_budget)}:{bw!r}"
    counters.reset()
    out = run_training(off_cfg, TrainLoopConfig(
        steps=STEPS, global_batch=BATCH, seq_len=SEQ, policy=policy_off,
        solver_impl="cuda_fused", log_every=1), device=dev, chain=off_chain,
        log_fn=say)
    path_launches["offload"] = counters.snapshot()
    plan = out["plan"]
    copied = moved(plan)
    if not copied:
        raise AssertionError("the offload run's plan copies no activation")
    need = max(int(off_chain.wa[i]) for i in copied)
    say(f"[offload] {off_cfg.name}, policy {policy_off}: schedule ops "
        f"{json.dumps(plan.op_counts())}, copies a^{copied} ({need} B the "
        f"largest), predicted {plan.expected_time:.6e} s/step, host peak "
        f"{plan.peak_host_mem:.6e} B, transfer stall "
        f"{plan.transfer_stall:.6e} s")
    for i, rec in enumerate(out["steps"]):
        say(f"[offload] step {i}: host buffer peak {rec['host_peak_bytes']} "
            f"B, prefetch wait {rec['prefetch_wait_s']:.6e} s on {card}")
        if rec["host_peak_bytes"] < need:
            raise AssertionError(f"step {i}: host buffer peak "
                                 f"{rec['host_peak_bytes']} B, below the "
                                 f"copied activation's {need} B")
        if rec["host_bytes_after"] != 0:
            raise AssertionError(f"step {i}: {rec['host_bytes_after']} B "
                                 f"left in the host buffer")
    report_steps("offload", plan, out["steps"])
    launches = path_launches["offload"]
    say(f"[offload] launches: {launches.get(dp_ops.NAME_FUSED_OFFLOAD, 0)} "
        f"fused offload fill per plan, "
        f"{launches[flash_ops.NAME] / STEPS:g} flash attention and "
        f"{launches[rms_ops.NAME] / STEPS:g} rms_norm per step")

    def offload_grads(params):
        loss, stage_grads, _ = execute_offload_schedule(
            plan.schedule, off_model.stage_fns(),
            off_model.stage_params(params), off_batch)
        return loss, tensors_of(off_model.combine_stage_grads(stage_grads))

    same_results("offload", out["params"], offload_grads, off_model,
                 off_batch)

    # one traced step of the same schedule: CUDA-event spans on the compute
    # stream (F*, B) and the side stream (Foff, Prefetch)
    traced = {"tracer": Tracer(name="phase 7 offload"), "stats": {},
              "host": HostBuffer()}

    def traced_offload_grads(params):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss, stage_grads, _ = execute_offload_schedule(
            plan.schedule, off_model.stage_fns(),
            off_model.stage_params(params), off_batch,
            host_buffer=traced["host"], stats=traced["stats"],
            tracer=traced["tracer"])
        torch.cuda.synchronize(dev)
        traced["seconds"] = time.perf_counter() - t0
        return loss, tensors_of(off_model.combine_stage_grads(stage_grads))

    fresh_metrics()
    same_results("offload traced", out["params"], traced_offload_grads,
                 off_model, off_batch)
    trace_report("offload", plan, traced["tracer"], "phase7_offload")
    spans = traced["tracer"].spans
    t_first = min(s_.t_start for s_ in spans)
    for s_ in spans:
        if s_.op in ("Foff", "Prefetch"):
            say(f"[offload] traced {s_.op}^{s_.arg} on the side stream: "
                f"{(s_.t_start - t_first) * 1e3:.4f} ms into the step, "
                f"{s_.duration * 1e3:.4f} ms, {s_.bytes} B on {card}")
    moved_s, hidden_s = transfer_overlap(spans)
    report = compare(plan, spans)
    gauge = obs_metrics.registry().get("host_buffer.bytes_in_use")
    say(f"[offload] traced step: copies {moved_s * 1e3:.4f} ms, "
        f"{hidden_s * 1e3:.4f} ms of it under compute spans (overlap share "
        f"{hidden_s / moved_s if moved_s else math.nan:.4f}); stall "
        f"predicted {plan.transfer_stall:.6e} s, measured "
        f"{traced['stats']['prefetch_wait_s']:.6e} s (the compute stream's "
        f"wait on prefetches) and {report.measured_stall:.6e} s (the "
        f"Prefetch spans); host buffer peak {int(gauge.max)} B "
        f"(host_buffer.bytes_in_use), the buffer's own "
        f"{traced['host'].peak_bytes} B; walker step "
        f"{traced['seconds']:.4f} s traced against "
        f"{statistics.median(r['seconds'] for r in out['steps']):.4f} s a "
        f"whole untraced step (AdamW included) on {card}")
    if int(gauge.max) != traced["host"].peak_bytes or gauge.max < need:
        raise AssertionError(f"host_buffer.bytes_in_use peaked at "
                             f"{gauge.max} B, the buffer at "
                             f"{traced['host'].peak_bytes} B, the copied "
                             f"activation has {need} B")
    del traced, spans
    offload_schedule = plan.schedule.ops
    del out, plan
    torch.cuda.empty_cache()

    # -- 8. planning with the other fill ----------------------------------------
    counters.reset()
    for pol, impl, want, pmodel, pspecs, pchain in (
            (policy_off, "cuda", offload_schedule, off_model, off_specs,
             off_chain),
            (f"rotor:{int(mid)}", "cuda_fused", rotor_schedule, model, specs,
             rotor_chain)):
        p, _ = plan_training(pmodel, pspecs, pol, impl=impl, device=dev,
                             chain=pchain)
        if p.schedule.ops != want:
            raise AssertionError(f"{pol} on {impl}: another schedule than "
                                 f"the training run's")
        say(f"[plan] {pol} on --solver-impl {impl}, the training run's "
            f"measured chain: the training run's schedule ({len(want)} ops)")
    path_launches["planning"] = counters.snapshot()

    # -- 9. Mamba path --------------------------------------------------------------
    measured_chains = {}  # each rotor path's measured chain, for phase 20

    def rotor_path(tag, arch, overrides, pcfg, what, kernels_run,
                   impl="cuda"):
        """Measure the chain of ``arch`` (with ``overrides``) on real tensors
        and train it for 3 steps through ``run_training(chain=measured)``
        under ``rotor:`` at the measured chain's midpoint budget, solved on
        the CUDA band-min kernel (``impl="cuda"``, K1) or the fused fill
        (``"cuda_fused"``, K2), counting launches; the training steps must
        launch that DP kernel and every kernel named in ``kernels_run``,
        and the plan must predict their forward and backward's activation
        peak within [1, 1.25] of the measured one; then the rotor plan and
        store-all agree on one batch.  The analytic chain's floors and its
        plan's predicted peak are printed beside the measured chain's.
        Returns the path's launch counts."""
        pmodel = StagedLM(pcfg)
        pspecs = input_specs(pcfg, ShapeSpec("train", "train", SEQ, BATCH))
        pchain = plan_chain(pmodel, pspecs, peak_flops)
        alow = solve_min_memory(pchain).mem_limit
        ahigh = pchain.store_all_peak()
        n_params = sum(t.numel()
                       for t in tensors_of(pmodel.init(device="meta")))
        say(f"[{tag}] {arch} cut to {pcfg.num_layers} layers: {n_params} "
            f"parameters, {what}; chunks {pcfg.chunks}")
        aplan, _ = plan_training(pmodel, pspecs,
                                 f"rotor:{int((alow + ahigh) / 2)}",
                                 impl="banded", chain=pchain)
        params = pmodel.init(0, dev)
        pbatch = SyntheticLMData(pcfg, BATCH, SEQ, seed=0).device_batch(0,
                                                                        dev)
        measured = show_measured(f"{arch}, {tag} path", pmodel, params,
                                 pbatch)
        measured_chains[tag] = measured
        plow = solve_min_memory(measured).mem_limit
        phigh = measured.store_all_peak()
        pbudget = (plow + phigh) / 2
        say(f"[{tag}] measured chain L={measured.length}: min-memory "
            f"{plow:.6e} B, store-all {phigh:.6e} B, budget (midpoint) "
            f"{int(pbudget)} B; analytic chain: min-memory {alow:.6e} B, "
            f"store-all {ahigh:.6e} B, its plan's predicted activation peak "
            f"at its own midpoint {aplan.peak_device_mem:.6e} B on {card}")
        counters.reset()
        out = run_training(pcfg, TrainLoopConfig(
            steps=STEPS, global_batch=BATCH, seq_len=SEQ,
            policy=f"rotor:{int(pbudget)}", solver_impl=impl, log_every=1),
            device=dev, params=params, chain=measured, log_fn=say)
        run = counters.snapshot()
        plan = out["plan"]
        say(f"[{tag}] schedule ops {json.dumps(plan.op_counts())}, "
            f"predicted {plan.expected_time:.6e} s/step, predicted "
            f"activation peak {plan.peak_device_mem:.6e} B")
        report_steps(tag, plan, out["steps"])
        dp_name = dp_ops.NAME if impl == "cuda" else dp_ops.NAME_FUSED
        for name in (dp_name, *kernels_run):
            if not run.get(name):
                raise AssertionError(f"the {tag} path never launched {name}")
        say(f"[{tag}] launches: {run[dp_name]} {dp_name} per plan, "
            + ", ".join(f"{run[k] / STEPS:g} {k}" for k in kernels_run)
            + " per step")

        def plan_grads(params):
            loss = pmodel.loss_fn(params, pbatch, tree=plan.tree)
            return loss, torch.autograd.grad(loss, tensors_of(params))

        same_results(f"{tag} rotor", out["params"], plan_grads, pmodel,
                     pbatch)
        del out, plan, params, measured
        torch.cuda.empty_cache()
        return run

    path_launches["mamba"] = rotor_path(
        "mamba", MAMBA_ARCH, MAMBA_OVERRIDES, mcfg,
        f"d_model {mcfg.d_model}, {Hs} SSM heads of {P}, state {N}, chunk "
        f"{Q}", (ssd_ops.NAME, rms_ops.NAME))

    # -- 10. the trade-off on the measured chain ----------------------------------
    def check_tradeoff(tag, trade):
        """Every point's loss and gradient norm (and its traced step's) must
        equal store-all's within 1e-2."""
        ref = trade["rows"][0]
        for r in trade["rows"]:
            for key in ("loss", "grad_norm", "traced_loss",
                        "traced_grad_norm"):
                want = ref[key.replace("traced_", "")]
                if key in r and not abs(r[key] - want) <= 1e-2 * abs(want):
                    raise AssertionError(
                        f"{tag}, {r['strategy']} at {r['budget_frac']}: "
                        f"{key} {r[key]} vs store-all {want}")
        say(f"[tradeoff] {tag}: every point's loss and gradient norm == "
            f"store-all's within 1e-2 ({ref['loss']:.6f}, "
            f"{ref['grad_norm']:.6f})")

    def emit_as(tag):
        return lambda s: say(f"[tradeoff] {tag}: {s} on {card}")

    def floor_budgets(tag, chain, base):
        """``base`` and two budgets between ``chain``'s two-tier floor and
        store-all, where the plans must run another schedule than
        store-all's (the steps that timed the chain)."""
        floor = solve_min_memory(chain).mem_limit / chain.store_all_peak()
        budgets = sorted({*base, *(round(floor + (1 - floor) * k / 3, 4)
                                   for k in (1, 2))})
        say(f"[{tag}] two-tier floor {floor:.4f} x store-all: budgets "
            f"{budgets} x store-all")
        return budgets

    def mape_line(tag, trade):
        """The MAPE over all points and over those whose schedule differs
        from store-all's, and the points left out."""
        say(f"[tradeoff] {tag}: time prediction MAPE "
            f"{trade['mape_percent']:.2f} % over {len(trade['rows'])} "
            f"points on the measured chain (its stage times inside the "
            f"chain, the chain run_training plans on), "
            f"{trade['mape_out_of_sample_percent']:.2f} % over the "
            f"{len(trade['out_of_sample'])} whose schedule differs from "
            f"store-all's ({', '.join(trade['out_of_sample'])}); left out, "
            f"store-all's schedule: {', '.join(trade['in_sample'])} on {card}")
        mapes[tag] = (trade["mape_percent"],
                      trade["mape_out_of_sample_percent"],
                      len(trade["out_of_sample"]))

    mapes = {}

    counters.reset()
    params = model.init(0, dev)
    # each point also runs one traced step (the nested checkpoints); the
    # spans give the per-stage drift, and the chain calibrated on them the
    # MAPE beside the uncalibrated one
    trade = run_lm_tradeoff(model, params, batch, impl="cuda", chain=measured,
                            budgets=floor_budgets("tradeoff", measured,
                                                  TRADEOFF_BUDGETS),
                            emit=emit_as("per-layer remat"), trace=True)
    check_tradeoff("per-layer remat", trade)
    for r in trade["rows"]:
        if r["strategy"] == "rotor":
            point = Tracer(name="phase 10 rotor")
            for s_ in r["spans"]:
                point.record(s_.op, s_.arg, s_.t_start, s_.t_end,
                             bytes=s_.bytes)
            trace_report("tradeoff", r["plan"], point,
                         f"phase10_rotor_{r['budget_frac']:g}")
    cal = trade["calibration"]
    mape_line("per-layer remat", trade)
    say(f"[tradeoff] per-layer remat: time prediction MAPE "
        f"{cal['mape_percent']:.2f} % on the chain calibrated on the traced "
        f"steps (no limit held) on {card}")
    del params, trade, cal
    torch.cuda.empty_cache()
    # the paper's setting: the planner is the only checkpointing, so each
    # chunk stage keeps its layer's saved tensors (no per-layer remat)
    nr_cfg = config_of(ARCH, OVERRIDES, scan_layer_remat="none")
    nr_model = StagedLM(nr_cfg)
    params = nr_model.init(0, dev)
    nr_measured = show_measured(f"{ARCH}, no per-layer remat", nr_model,
                                params)
    trade = run_lm_tradeoff(nr_model, params, batch, impl="cuda",
                            chain=nr_measured,
                            budgets=floor_budgets("tradeoff", nr_measured,
                                                  TRADEOFF_BUDGETS),
                            emit=emit_as("no per-layer remat"))
    check_tradeoff("no per-layer remat", trade)
    mape_line("no per-layer remat", trade)
    del trade
    path_launches["measured"] = counters.snapshot()
    launches = path_launches["measured"]
    say(f"[measured] launches: {launches.get(dp_ops.NAME, 0)} dp band-min "
        f"(the trade-off plans), {launches.get(flash_ops.NAME, 0)} flash "
        f"attention and {launches.get(rms_ops.NAME, 0)} rms_norm")
    del params
    torch.cuda.empty_cache()

    # -- 11. Zamba2 path ------------------------------------------------------------
    zslice = ssd_ops.head_slice(torch.bfloat16, P, zN, Q, zHs, zG)
    say(f"[zamba] K6 at state {zN}: the launcher takes the "
        f"{ssd_kind(torch.bfloat16, zHs, zG, zN)} for bf16 x "
        f"({BATCH},{SEQ},{zHs},{P}), B/C ({BATCH},{SEQ},{zG},{zN}), chunk "
        f"{Q} (ssd/ops.py::head_slice)")
    if zslice != 8:
        raise AssertionError(f"K6 at state {zN}: slices of {zslice} heads, "
                             f"not the tensor-core kernel's 8")
    path_launches["zamba"] = rotor_path(
        "zamba", ZAMBA_ARCH, ZAMBA_OVERRIDES, zcfg,
        f"d_model {zcfg.d_model}, {zHs} SSM heads of {P}, state {zN}, chunk "
        f"{Q}, the shared block at {zcfg.n_heads} heads × {zcfg.head_dim} and "
        f"d_ff {zcfg.d_ff} every {zcfg.hybrid_period} layers, vocab "
        f"{zcfg.vocab_size}", (flash_ops.NAME, rms_ops.NAME, ssd_ops.NAME))

    # -- 12. MoE path ---------------------------------------------------------------
    path_launches["moe"] = rotor_path(
        "moe", MOE_ARCH, MOE_OVERRIDES, ecfg,
        f"d_model {ecfg.d_model}, {ecfg.n_heads} heads × {ecfg.head_dim}, "
        f"dense d_ff {ecfg.d_ff}, {ecfg.num_experts} experts top-"
        f"{ecfg.moe_top_k} of d_ff {ecfg.moe_d_ff} and "
        f"{ecfg.num_shared_experts} shared, capacity factor "
        f"{ecfg.moe_capacity_factor}, vocab {ecfg.vocab_size}",
        (flash_ops.NAME, rms_ops.NAME))

    # -- 13. the paper's conv chain ----------------------------------------------
    counters.reset()
    cstages, cparams, cx = paper_resnet.resnet_ish_chain(**RESNET, device=dev)
    t0 = time.perf_counter()
    calone = profile_stages_measured(cstages, cparams, cx)
    cchain, which = time_stages_in_chain(cstages, cparams, cx, calone)
    say(f"[resnet] the paper's heterogeneous conv chain, {RESNET}: input "
        f"{tuple(cx.shape)} float32, {cchain.length + 1} stages measured in "
        f"{time.perf_counter() - t0:.2f} s (each stage alone: 1 warm-up, "
        f"median of 3; then inside the chain) on {card}")
    for line in in_chain_lines(calone, cchain, which):
        say(f"[resnet] {line} on {card}")
    say("[resnet] stage: uf s, ub s, wa B, wabar B, of B, ob B")
    for i in range(cchain.length + 1):
        say(f"[resnet] {i + 1}: {cchain.uf[i]:.6e}, {cchain.ub[i]:.6e}, "
            f"{int(cchain.wa[i])}, {int(cchain.wabar[i])}, "
            f"{int(cchain.of[i])}, {int(cchain.ob[i])} on {card}")
    # each stage's backward transient measured in isolation (the chain's
    # ob) beside the same backward inside the chain's own store-all backward
    inchain = chain_backward_transients(cstages, cparams, cx)
    say("[resnet] stage: backward transient in isolation (ob) B, inside the "
        "chain B, isolated / in-chain")
    for i, got in enumerate(inchain):
        iso = int(cchain.ob[i])
        say(f"[resnet] {i + 1}: {iso}, {got}, "
            f"{iso / got if got else float('nan'):.4f} on {card}")
        if abs(iso - got) > 0.05 * got + (1 << 20) + 512:
            raise AssertionError(
                f"conv chain stage {i + 1}: the isolated backward transient "
                f"{iso} B is not within 5 % plus one allocator rounding of "
                f"the in-chain one, {got} B")
    # the reference's budgets, and two between the measured chain's two-tier
    # floor and store-all (where the floor lies above the reference's lower
    # budgets)
    budgets = floor_budgets("resnet", cchain, paper_resnet.BUDGETS)
    trade = run_tradeoff(cstages, cparams, cx, items=cx.shape[0],
                         impl="cuda", chain=cchain, budgets=budgets,
                         emit=emit_as("conv chain"))
    check_tradeoff("conv chain", trade)
    mape_line("conv chain", trade)
    path_launches["resnet"] = counters.snapshot()
    below = sorted(f for f in trade["gain_measured_at"] if f < 1.0)
    say(f"[resnet] rotor over best sequential, measured below store-all at "
        f"{below} x store-all; MAPE {trade['mape_percent']:.2f} %, "
        f"{trade['mape_out_of_sample_percent']:.2f} % over the points whose "
        f"schedule differs from store-all's; "
        f"{path_launches['resnet'].get(dp_ops.NAME, 0)} dp band-min launches "
        f"on {card}")
    if len(below) < 2:
        raise AssertionError(f"rotor's gain over sequential read at "
                             f"{len(below)} budgets below store-all, not 2")
    if not path_launches["resnet"].get(dp_ops.NAME):
        raise AssertionError("the conv chain's trade-off never launched "
                             "dp band-min")

    def op_peaks(plan):
        """``(predicted device bytes during the op, op, stage)`` for every op
        of a two-tier plan, from its timeline on its chain, largest first."""
        ch, mem, got = plan.chain, float(plan.chain.wa[0]), []
        for r in plan.timeline():
            k, l = r["op"], r["arg"]
            if k == "B":
                got.append((mem + ch.ob[l - 1], k, l))
            else:
                new = (ch.wabar[l - 1] if k == "Fall"
                       else ch.wa[l] if l <= ch.length else 0.0)
                got.append((mem + new + ch.of[l - 1], k, l))
            mem = r["device_mem"]
        return sorted(got, reverse=True)

    # where the simulator puts each plan's peak at the lowest budget with a
    # gain reading, beside the measured peak (plans on the numpy fill, after
    # the path's counts were read)
    f = below[0]
    k_seq = best_periodic(cchain, f * cchain.store_all_peak())[0]
    for name, pol in (
            ("store-all", "none"),
            (f"sequential(k={k_seq})", f"periodic:{k_seq}"),
            ("rotor", f"rotor:{int(f * cchain.store_all_peak())}")):
        got = next(r["measured_peak_bytes"] for r in trade["rows"]
                   if r["strategy"] == name
                   and (name == "store-all" or r["budget_frac"] == f))
        say(f"[resnet] {name}{'' if name == 'store-all' else f' at {f}'}: "
            f"the simulator's largest op peaks "
            + ", ".join(f"{k}^{l} {m:.6e} B" for m, k, l
                        in op_peaks(resolve_policy(pol, cchain))[:3])
            + f"; measured peak {got} B on {card}")
    del cstages, cparams, cx, cchain, trade
    torch.cuda.empty_cache()

    # -- 14. MLA path ----------------------------------------------------------------
    path_launches["mla"] = rotor_path(
        "mla", MLA_ARCH, MLA_OVERRIDES, dcfg,
        f"d_model {dcfg.d_model}, {dcfg.n_heads} MLA heads (latent "
        f"{dcfg.kv_lora_rank}, qk {dcfg.qk_nope_head_dim}+"
        f"{dcfg.qk_rope_head_dim}, v {dcfg.v_head_dim}), dense d_ff "
        f"{dcfg.d_ff}, {dcfg.num_experts} experts top-{dcfg.moe_top_k} of "
        f"d_ff {dcfg.moe_d_ff} and {dcfg.num_shared_experts} shared, vocab "
        f"{dcfg.vocab_size}", (rms_ops.NAME,))

    # -- 15-16. serving ----------------------------------------------------
    path_launches["serve"] = serve_qwen(card, host)
    path_launches["serve_archs"] = serve_archs(card)

    # -- 17. PaliGemma: the VLM at its published 18 layers ----------------
    path_launches["paligemma"] = rotor_path(
        "paligemma", VLM_ARCH, FLASH_ON, vcfg,
        f"d_model {vcfg.d_model}, {vcfg.n_heads} heads × {vcfg.head_dim} on "
        f"{vcfg.n_kv_heads} KV head, GeGLU d_ff {vcfg.d_ff}, vocab "
        f"{vcfg.vocab_size}, {vcfg.prefix_len} image embeddings + "
        f"{SEQ - vcfg.prefix_len} tokens (the prefix bidirectional: plain "
        f"attention), embedding scale", (rms_ops.NAME,), impl="cuda_fused")

    # -- 18. MusicGen: the audio decoder at its published 48 layers -------
    path_launches["musicgen"] = rotor_path(
        "musicgen", AUDIO_ARCH, FLASH_ON, acfg,
        f"d_model {acfg.d_model}, {acfg.n_heads} heads × {acfg.head_dim}, "
        f"GELU d_ff {acfg.d_ff}, vocab {acfg.vocab_size}, {SEQ} frame "
        f"embeddings + sinusoidal positions (an embed stage without "
        f"parameters)", (flash_ops.NAME, rms_ops.NAME))

    # -- 19. serving PaliGemma and MusicGen ---------------------------------
    path_launches.update(serve_vlm_audio(card))

    # -- 20. persistence and resume -----------------------------------------
    counters.reset()
    path_launches["persist"] = persistence(card, model, measured, batch,
                                           mcfg, measured_chains["mamba"])
    say(f"[persist] phase 20 launches: "
        f"{json.dumps(path_launches['persist'])}")

    fresh_metrics()
    if not verified[0]:
        raise AssertionError("REPRO_CHECK=1 verified no plan in phases 6-20")
    say(f"[check] REPRO_CHECK=1: {verified[0]} MemoryPlan.verify calls as "
        f"phases 6-20 built, bound, executed, served, saved or loaded their "
        f"plans, every report ok")
    say(f"[mape] time prediction MAPE of the chains the port plans on "
        f"(stage times inside the chain), all points / the points whose "
        f"schedule differs from store-all's (their count): " + "; ".join(
            f"{k} {a:.2f} % / {b:.2f} % ({n})"
            for k, (a, b, n) in mapes.items())
        + f" (paper §5.3: 7.8 %; no limit held) on {card}")

    # -- 21. multi-device -----------------------------------------------------
    path_launches["multi_device"], plain21 = multi_device(card)

    # -- 22. model-axis tensor parallelism and serving on a mesh --------------
    path_launches.update(tensor_parallel(card, plain21))

    # -- 23. the roofline on the card -----------------------------------------
    path_launches.update(roofline(card, measured))

    # -- result lines -----------------------------------------------------
    # K3's head dim on each path that launches it
    head_dims = {"rotor": cfg.head_dim, "offload": off_cfg.head_dim,
                 "measured": cfg.head_dim,
                 "zamba": zcfg.head_dim, "moe": ecfg.head_dim,
                 "serve": get_config("qwen1.5-4b").head_dim,
                 "serve_archs": zcfg.head_dim, "musicgen": acfg.head_dim,
                 "serve_paligemma": vcfg.head_dim,
                 "serve_musicgen": acfg.head_dim, "persist": cfg.head_dim,
                 "multi_device": cfg.head_dim, "tp_qwen": cfg.head_dim,
                 "tp_launcher": cfg.head_dim,
                 "tp_zamba": zcfg.head_dim, "tp_serve": cfg.head_dim,
                 "roofline_train": cfg.head_dim,
                 "roofline_decode": get_config("qwen1.5-4b").head_dim}
    for kern in kernels:
        per_path = {k: v.get(kern["name"], 0) for k, v in path_launches.items()}
        kern["launches"] = sum(per_path.values())
        say(f"[launches] {kern['name']}: {json.dumps(per_path)}"
            + (" (DP fills: solver-cache misses only; a hit launches none)"
               if kern["name"] in (dp_ops.NAME, dp_ops.NAME_OFFLOAD,
                                   dp_ops.NAME_FUSED) else ""))
        if kern["launches"] == 0:
            raise AssertionError(f"{kern['name']} never launched on a path")
        del kern["shape"]
        if kern["name"] != flash_ops.NAME:
            continue
        by_dim = {}
        for path, n in per_path.items():
            if n:
                by_dim[str(head_dims[path])] = (
                    by_dim.get(str(head_dims[path]), 0) + n)
        kern["launches_by_head_dim"] = by_dim
        say(f"[launches] {kern['name']} by head dim: {json.dumps(by_dim)}")
        for d in (vcfg.head_dim, acfg.head_dim):
            if not by_dim.get(str(d)):
                raise AssertionError(f"K3 never launched at head dim {d}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
