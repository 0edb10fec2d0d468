"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and
check it, phase by phase; any failed phase ends the run with a non-zero exit.

    python3 chip_smoke.py          # from the root of a checkout

1. environment: versions, the card, and ``nvidia-smi``'s name and power limit;
2. build: the CUDA kernels (one ``nvcc`` per source, in parallel) and the
   Triton RMSNorm;
3. kernel vs plain: each kernel against its plain PyTorch version on the same
   CUDA inputs — the DP band-min bit-equal (also a whole DP table against the
   numpy fill), flash attention within 2e-2 in bf16 (and within 2 bf16 ulps
   of the float32 plain version on the same inputs) and 1e-4 in f32, RMSNorm
   within one bf16 ulp and rtol 1e-6 in f32;
4. timing: median of 20 CUDA-event runs of each kernel, its plain version and
   the PyTorch library call for the same function, at the main path's shapes,
   beside the least time the card could take (bytes or operations);
5. main path: ``repro_torch.launch.train.main`` trains Qwen1.5-4B at full
   width, cut to 8 layers, batch 4 × 2048 tokens, 3 steps, under the rotor
   plan solved on the CUDA band-min kernel at the midpoint budget between the
   min-memory and store-all peaks; kernel launch counts are read from zero;
6. same results: loss and global gradient norm under the rotor plan and
   under store-all agree within 1e-2 on one batch;
7. one JSON line describing every kernel, then the final JSON result line.

Without CUDA, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
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

ARCH = "qwen1.5-4b"
LAYERS, BATCH, SEQ, STEPS = 8, 4, 2048, 3
OVERRIDES = {"num_layers": LAYERS, "layer_kinds": ["dense"] * LAYERS,
             "n_chunks": LAYERS, "use_flash_attention": True}


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


def bound(nbytes: float, ops: float, peak_ops: float):
    """(ms, "bytes"|"operations"): the least time for the work."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bf16_ulp(x):
    import torch

    mag = torch.clamp(x.abs().float(), min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


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

    from repro_torch import counters
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec, input_specs
    from repro_torch.core import dp_kernels
    from repro_torch.core.solver import solve_min_memory
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import _build
    from repro_torch.kernels.dp_fill import ops as dp_ops
    from repro_torch.kernels.dp_fill import ref as dp_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.launch import train
    from repro_torch.launch.steps import plan_chain
    from repro_torch.models.lm import StagedLM
    from repro_torch.optim.adamw import global_norm
    from repro_torch.plan.plan import DEFAULT_NUM_SLOTS
    from repro_torch.tree import tensors_of

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- 1. environment ----------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
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
    t0 = time.perf_counter()
    rms_ops.rms_norm_fwd(randn(4, 2560, dtype=torch.bfloat16),
                         torch.ones(2560, device=dev, dtype=torch.bfloat16))
    torch.cuda.synchronize()
    say(f"[build] triton rms_norm compiled and ran in "
        f"{time.perf_counter() - t0:.2f}s")

    # -- 3. kernel vs plain -----------------------------------------------------
    cfg = get_config(ARCH, **{k: tuple(v) if isinstance(v, list) else v
                              for k, v in OVERRIDES.items()})
    model = StagedLM(cfg)
    specs = input_specs(cfg, ShapeSpec("train", "train", SEQ, BATCH))

    def planes(d, ns, w):
        r = torch.rand((d, ns, w), generator=gen, device=dev) * 8
        r[torch.rand((d, ns, w), generator=gen, device=dev) < 0.3] = math.inf
        lm = torch.rand((d, ns, w), generator=gen, device=dev) * 8 - 4
        return r, lm

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

    n = 8192
    a, b = randn(n, n, dtype=torch.bfloat16), randn(n, n, dtype=torch.bfloat16)
    peak_flops = 2 * n ** 3 / (median_ms(lambda: a @ b, reps=10) * 1e-3)
    del a, b
    say(f"[env] measured bf16 matmul rate {peak_flops:.6e} FLOP/s "
        f"({n}^3) on {card}")
    chain = plan_chain(model, specs, peak_flops)
    low = solve_min_memory(chain).mem_limit
    high = chain.store_all_peak()
    budget = (low + high) / 2
    dchain = chain.discretize(budget, DEFAULT_NUM_SLOTS)
    tab_cuda = dp_kernels.fill_tables(dchain, DEFAULT_NUM_SLOTS, impl="cuda")
    tab_np = dp_kernels.fill_tables(dchain, DEFAULT_NUM_SLOTS, impl="banded")
    if not np.array_equal(tab_cuda.data, tab_np.data):
        raise AssertionError("CUDA DP table differs from the banded fill")
    say(f"[check] DP table of the card chain (L={chain.length}, "
        f"S={DEFAULT_NUM_SLOTS}, budget {budget:.6e} B): cuda == banded")

    def check_close(name, got, want, tol):
        err = (got.float() - want.float()).abs()
        lim = tol + tol * want.float().abs()
        if not bool(torch.all(err <= lim)):
            raise AssertionError(f"{name}: max |err| {float(err.max())} "
                                 f"above {tol}")
        return float(err.max())

    flash_err = {}
    for (B, S, H, K, D) in ((2, 200, 8, 2, 16), (1, 300, 4, 1, 64),
                            (BATCH, SEQ, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim)):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            q, k, v = (randn(B, S, h, D, dtype=dtype) for h in (H, K, K))
            err = check_close(f"flash {B, S, H, K, D} {dtype}",
                              flash_ops.attention_fwd(q, k, v),
                              flash_ref.attention(q, k, v), tol)
            flash_err[(B, S, H, K, D, dtype)] = err
            say(f"[check] flash_attention_fwd {(B, S, H, K, D)} {dtype}: "
                f"max |err| {err:.3e} (tol {tol})")
            if dtype == torch.bfloat16:
                # the kernel computes in float32 and rounds once on the store:
                # hold it to the float32 plain version of the same bf16 inputs
                # within 2 bf16 ulps (+1e-5 for outputs near zero)
                got = flash_ops.attention_fwd(q, k, v).float()
                want = flash_ref.attention(q.float(), k.float(), v.float())
                gap = (got - want).abs()
                if not bool(torch.all(gap <= 2 * bf16_ulp(want) + 1e-5)):
                    raise AssertionError(
                        f"flash {B, S, H, K, D} bf16: max |err| vs float32 "
                        f"{float(gap.max())} above 2 bf16 ulps")
                say(f"[check] flash_attention_fwd {(B, S, H, K, D)} bf16 vs "
                    f"float32 plain: max |err| {float(gap.max()):.3e} "
                    f"(tol 2 bf16 ulp + 1e-5)")
                del got, want, gap
            del q, k, v

    rows = BATCH * SEQ
    xs = {dt: randn(rows, cfg.d_model, dtype=dt)
          for dt in (torch.bfloat16, torch.float32)}
    sc = {dt: (1 + 0.1 * randn(cfg.d_model)).to(dt) for dt in xs}
    got = rms_ops.rms_norm_fwd(xs[torch.bfloat16], sc[torch.bfloat16])
    want = rms_ref.rms_norm(xs[torch.bfloat16], sc[torch.bfloat16])
    rms_err = float((got.float() - want.float()).abs().max())
    if not bool(torch.all((got.float() - want.float()).abs()
                          <= bf16_ulp(want))):
        raise AssertionError("rms_norm bf16 differs by more than one ulp")
    got = rms_ops.rms_norm_fwd(xs[torch.float32], sc[torch.float32])
    want = rms_ref.rms_norm(xs[torch.float32], sc[torch.float32])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    say(f"[check] rms_norm ({rows}, {cfg.d_model}): bf16 within 1 ulp "
        f"(max |err| {rms_err:.3e}), f32 rtol 1e-6")

    # -- 4. timing at the main path's shapes -------------------------------------
    kernels = []
    caps = dp_kernels.saturation_caps(dp_kernels._views(dchain),
                                      DEFAULT_NUM_SLOTS)
    ms = plain_ms = lib_ms = nbytes = ops = 0.0
    for d in range(1, chain.length + 1):
        ns = chain.length + 1 - d
        w = dp_kernels.band_width(caps, d, DEFAULT_NUM_SLOTS)
        r, lm = planes(d, ns, w)
        ms += median_ms(lambda: dp_ops.band_min_two_tier(r, lm))
        plain_ms += median_ms(lambda: dp_ref.band_min_two_tier(r, lm))
        # the library call is the plain version's own expression
        lib_ms += median_ms(lambda: torch.amin(r + lm, 0))
        nbytes += 4 * (2 * d + 1) * ns * w
        ops += 2 * d * ns * w
    b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
    kernels.append({
        "name": dp_ops.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dp_band_min.cu",
        "replaces": "src/repro/kernels/dp_fill/kernel.py:86",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "max_abs_err": dp_err,
        "shape": f"one fill: {chain.length} bands of (d, L+1-d, W)"})

    B, S, H, K, D = BATCH, SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (randn(B, S, h, D, dtype=torch.bfloat16) for h in (H, K, K))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    flops = 4 * D * (S * (S + 1) // 2) * B * H   # unmasked QK^T and PV
    b_ms, b_by = bound(2 * (2 * B * S * H * D + 2 * B * S * K * D), flops,
                       BF16_TENSOR_FLOPS)
    kernels.append({
        "name": flash_ops.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attn_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:77",
        "ms": median_ms(lambda: flash_ops.attention_fwd(q, k, v)),
        "plain_ms": median_ms(lambda: flash_ref.attention(q, k, v)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        "max_abs_err": flash_err[(B, S, H, K, D, torch.bfloat16)],
        "shape": f"bf16 q ({B},{S},{H},{D}) k,v ({B},{S},{K},{D})"})
    del q, k, v, qt, kt, vt

    x, s = xs[torch.bfloat16], sc[torch.bfloat16]
    b_ms, b_by = bound(2 * 2 * rows * cfg.d_model + 2 * cfg.d_model,
                       4 * rows * cfg.d_model, F32_FLOPS)
    kernels.append({
        "name": rms_ops.NAME, "route": "triton",
        "source": "src/repro_torch/kernels/rmsnorm/kernel.py",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:24",
        "ms": median_ms(lambda: rms_ops.rms_norm_fwd(x, s)),
        "plain_ms": median_ms(lambda: rms_ref.rms_norm(x, s)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": median_ms(lambda: F.rms_norm(x, (cfg.d_model,), s,
                                                   1e-6)),
        "max_abs_err": rms_err, "shape": f"bf16 ({rows}, {cfg.d_model})"})
    del xs, sc, x, s
    for kern in kernels:
        say(f"[time] {kern['name']} {kern['shape']}: {kern['ms']:.4f} ms, "
            f"plain {kern['plain_ms']:.4f} ms, library "
            f"{kern['library_ms']} ms, bound {kern['bound_ms']:.4f} ms "
            f"({kern['bound_by']}) on {card}")
    torch.cuda.empty_cache()

    # -- 5. the main path -------------------------------------------------------
    say(f"[main] chain L={chain.length}: min-memory {low:.6e} B, store-all "
        f"{high:.6e} B, budget (midpoint) {int(budget)} B")
    counters.reset()
    out = train.main([
        "--arch", ARCH, "--override", json.dumps(OVERRIDES),
        "--global-batch", str(BATCH), "--seq-len", str(SEQ),
        "--steps", str(STEPS), "--policy", f"rotor:{int(budget)}",
        "--solver-impl", "cuda", "--peak-flops", repr(peak_flops)])
    launches = counters.snapshot()
    plan = out["plan"]
    say(f"[main] schedule ops {json.dumps(plan.op_counts())}, predicted "
        f"{plan.expected_time:.6e} s/step, predicted activation peak "
        f"{plan.peak_device_mem:.6e} B")
    for i, rec in enumerate(out["steps"]):
        say(f"[main] step {i}: loss {rec['loss']:.6f}, "
            f"{rec['tokens_per_s']:.1f} tok/s, {rec['seconds']:.4f} s, "
            f"measured activation peak {rec['activation_peak_bytes']} B "
            f"on {card}")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"non-finite loss: {out['losses']}")
    for kern in kernels:
        kern["launches"] = launches.get(kern["name"], 0)
        if kern["launches"] == 0:
            raise AssertionError(f"{kern['name']} never launched on the "
                                 f"main path")
    say(f"[main] launches: {launches[dp_ops.NAME]} dp band-min per plan, "
        f"{launches[flash_ops.NAME] / STEPS:g} flash attention and "
        f"{launches[rms_ops.NAME] / STEPS:g} rms_norm per step")

    # -- 6. same results: rotor plan vs store-all ------------------------------
    params = out["params"]
    leaves = tensors_of(params)
    batch = SyntheticLMData(cfg, BATCH, SEQ, seed=0).device_batch(0, dev)
    res = {}
    for name, tree in (("rotor", plan.tree), ("none", None)):
        loss = model.loss_fn(params, batch, tree=tree)
        grads = torch.autograd.grad(loss, leaves)
        res[name] = (loss.item(), global_norm(grads).item())
        del loss, grads
    for i, what in enumerate(("loss", "grad norm")):
        a_, b_ = res["rotor"][i], res["none"][i]
        if not abs(a_ - b_) <= 1e-2 * abs(b_):
            raise AssertionError(f"{what}: rotor {a_} vs store-all {b_}")
    say(f"[same] rotor vs store-all: loss {res['rotor'][0]:.6f} / "
        f"{res['none'][0]:.6f}, grad norm {res['rotor'][1]:.6f} / "
        f"{res['none'][1]:.6f} (rel tol 1e-2)")

    # -- 7. result lines ----------------------------------------------------------
    for kern in kernels:
        del kern["shape"]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
