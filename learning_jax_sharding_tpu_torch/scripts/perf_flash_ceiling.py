"""The flash kernels' ceiling at long context, on the card.

Port of ``scripts/perf_flash_ceiling.py``:

1. the flash forward and forward + backward at B=2, S=8192, causal, at one
   width in two head shapes (16 × 64, 8 × 128): TFLOP/s against the card's
   bf16 peak, SDPA on the same inputs beside each;
2. the composed train step of a 125M-class model at S=8192 with 6 heads of
   128 (the same 768 width), b=2, two steps a call, causal and with a
   1024-token window: ms per step and MFU, window rows on window-adjusted
   FLOPs;
3. the flash block's ablation: ``ops/probes.py::ablate_probe`` over 16
   blocks of 1024 rows at h = 64 and 128 in its three modes (full softmax,
   no exponentials, products only), µs a block against the products' time
   at peak; beside ``full``, the port's flash forward on the same work (16
   slabs of 1024 rows, one head, non-causal, scale 1: ``full``'s function);
4. the composed step at S=16384, b=1, causal and windowed.

    python -m learning_jax_sharding_tpu_torch.scripts.perf_flash_ceiling
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_125M,
    Transformer,
    fused_next_token_loss,
)
from learning_jax_sharding_tpu_torch.ops import flash_attention as flash
from learning_jax_sharding_tpu_torch.ops.probes import ablate_flops, ablate_probe, column_sums
from learning_jax_sharding_tpu_torch.training.loop import adamw
from learning_jax_sharding_tpu_torch.training.pipeline import make_train_step, sharded_train_state
from learning_jax_sharding_tpu_torch.utils.bench import (
    device_peak_flops,
    device_profile,
    measure,
    queued_time,
    time_fn,
)

B, S = 2, 8192
HEAD_SHAPES = ((16, 64), (8, 128))
#: The composed steps' (b, s): part 2 and part 4.
SHAPE_8K, SHAPE_16K = (2, 8192), (1, 16384)
STEPS_PER_CALL = 2
WINDOW = 1024
BLOCK, BLOCKS = 1024, 16
ABLATE_HEAD_DIMS = (64, 128)
MODES = ("full", "noexp", "dots")
#: The 125M width as 6 heads of 128, at long context, with the flash kernels.
CONFIG_8K = dataclasses.replace(CONFIG_125M, num_heads=6, head_dim=128, max_seq_len=8192,
                                attn_fn=flash.make_flash_attn_fn())


def _peak() -> float:
    return device_peak_flops() or 989e12


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)


def kernel_bench(seed: int = 0, log=print) -> dict:
    """Part 1: the flash forward and forward + backward, causal, at (B, S)
    per head shape, beside SDPA (its flash backend) on the same inputs.
    FLOPs: 4·B·N·(S²/2)·H forward, 3.5× that forward + backward (the
    backward's five products against the forward's two)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for n, h in HEAD_SHAPES:
        q, k, v = (_randn(gen, B, S, n, h) for _ in range(3))
        flops = 4 * B * n * (S * S / 2) * h
        fwd = functools.partial(flash.flash_attention, causal=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def fwd_bwd(attn, *args):
            args = [a.detach().requires_grad_() for a in args]
            attn(*args).float().sum().backward()

        t_fwd = time_fn(fwd, q, k, v)
        t_sdpa = time_fn(sdpa, qt, kt, vt, is_causal=True)
        t_both = time_fn(fwd_bwd, fwd, q, k, v, inner=3)
        t_sdpa_both = time_fn(fwd_bwd, functools.partial(sdpa, is_causal=True), qt, kt, vt,
                              inner=3)
        row = dict(fwd_ms=t_fwd * 1e3, fwd_tflop_s=flops / t_fwd / 1e12,
                   sdpa_fwd_ms=t_sdpa * 1e3, sdpa_fwd_tflop_s=flops / t_sdpa / 1e12,
                   fwd_bwd_ms=t_both * 1e3, fwd_bwd_tflop_s=3.5 * flops / t_both / 1e12,
                   sdpa_fwd_bwd_ms=t_sdpa_both * 1e3,
                   sdpa_fwd_bwd_tflop_s=3.5 * flops / t_sdpa_both / 1e12, flops=flops)
        rows[f"{n}x{h}"] = row
        log(f"[flash] part 1, B={B} S={S} {n}x{h} causal bf16: forward {t_fwd * 1e3:.3f} ms, "
            f"{row['fwd_tflop_s']:.1f} TFLOP/s ({flops / t_fwd / _peak():.1%} of peak; SDPA "
            f"{t_sdpa * 1e3:.3f} ms, {row['sdpa_fwd_tflop_s']:.1f}); forward + backward "
            f"{t_both * 1e3:.3f} ms, {row['fwd_bwd_tflop_s']:.1f} TFLOP/s nominal "
            f"({3.5 * flops / t_both / _peak():.1%}; SDPA {t_sdpa_both * 1e3:.3f} ms, "
            f"{row['sdpa_fwd_bwd_tflop_s']:.1f})")
        del q, k, v, qt, kt, vt
    return rows


def step_flops(cfg, b: int, s: int, window: int | None) -> float:
    """``train_step_flops``, with the attention term window-adjusted as the
    JAX script adjusts it (:89-95): the causal half's S² shrunk to the
    window's share of it."""
    flops = cfg.train_step_flops(b, s)
    if window is not None:
        full_attn = 3 * (4 * s * cfg.num_heads * cfg.head_dim * cfg.num_layers) * 0.5 * b * s
        flops = flops - full_attn + full_attn * min(1.0, window / (s / 2))
    return flops


def composed(label, cfg, b: int, s: int, *, window: int | None = None, steps: int = STEPS_PER_CALL,
             seed: int = 0, profile: bool = False, log=print) -> dict:
    """A composed train step (flash attention, fused loss, AdamW, ``steps``
    steps a call) at ``(b, s)``: ms per step and MFU, and the flash
    launches of one call (every one must be on the tensor cores). With
    ``profile``, one more call under the profiler: device-busy ms a step,
    the idle share and the top kernels."""
    if window is not None:
        cfg = dataclasses.replace(cfg, attn_fn=flash.make_flash_attn_fn(window=window))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device="cuda")
    batch = {"inputs": tokens[:, :-1].contiguous(), "targets": tokens[:, 1:].contiguous()}
    stacked = {k: v.expand(steps, *v.shape) for k, v in batch.items()}
    state = sharded_train_state(Transformer(cfg, device="cuda", seed=seed), adamw(3e-4))
    step = make_train_step(loss_fn=functools.partial(fused_next_token_loss, chunk_size=128),
                           loss_needs_params=True, apply_kwargs={"return_hidden": True},
                           steps_per_call=steps)
    step(state, stacked)
    torch.cuda.synchronize()
    flash.flash_attention.launches = dict.fromkeys(flash.flash_attention.launches, 0)
    _, losses = step(state, stacked)
    torch.cuda.synchronize()
    launches = dict(flash.flash_attention.launches)
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{label}: non-finite losses {losses.tolist()}")
    flops = step_flops(cfg, b, s, window)
    r = measure(step, state, stacked, flops=flops * steps, warmup=0)
    row = dict(ms_per_step=r.seconds_per_iter / steps * 1e3, mfu=r.mfu, flops_per_step=flops,
               call_seconds=list(r.samples), flash_launches=launches, losses=losses.tolist())
    log(f"[flash] {label}: {row['ms_per_step']:.3f} ms/step, MFU {r.mfu:.4f} "
        f"({flops / 1e12:.3f} TFLOP/step; calls {[round(x, 4) for x in r.samples]} s); flash "
        f"launches of one {steps}-step call {launches}")
    if profile:
        prof = device_profile(lambda: step(state, stacked), steps)
        top = [(name[:60], round(ms, 3)) for name, ms in prof["by_name"].most_common(6)]
        row.update(busy_ms_per_step=prof["busy_ms"], idle_share=1 - prof["busy_ms"] /
                   row["ms_per_step"], top_ms_per_step=top,
                   port_ms_per_step={k: round(v, 3) for k, v in prof["port_ms_by_name"].items()})
        log(f"[flash] {label}, profiled: device busy {prof['busy_ms']:.3f} ms a step (idle share "
            f"{row['idle_share']:.3f}), {prof['kernels']:.0f} kernels a step; top {top}; the "
            f"port's {row['port_ms_per_step']}")
    del state, step
    torch.cuda.empty_cache()
    return row


def composed_8k(log=print, windowed_only: bool = False) -> dict:
    """Part 2: S=8192, b=2, causal (unless ``windowed_only``) and window
    1024."""
    (b, s), rows = SHAPE_8K, {}
    if not windowed_only:
        rows["causal"] = composed(f"part 2, S={s} b={b} hd=128 flash causal", CONFIG_8K, b, s,
                                  profile=True, log=log)
    rows["window"] = composed(f"part 2, S={s} b={b} hd=128 banded window {WINDOW}", CONFIG_8K, b,
                              s, window=WINDOW, log=log)
    return rows


def composed_16k(log=print) -> dict:
    """Part 4: S=16384, b=1 (the fp32 hidden states of the step fit without
    remat), causal and window 1024."""
    b, s = SHAPE_16K
    cfg = dataclasses.replace(CONFIG_8K, max_seq_len=s)
    return {"causal": composed(f"part 4, S={s} b={b} hd=128 flash causal", cfg, b, s, log=log),
            "window": composed(f"part 4, S={s} b={b} hd=128 banded window {WINDOW}", cfg, b, s,
                               window=WINDOW, log=log)}


def ablation_inputs(h: int, seed: int = 0):
    gen = torch.Generator(device="cuda").manual_seed(seed + h)
    return tuple(_randn(gen, BLOCKS * BLOCK, h) for _ in range(3))


def ablation(seed: int = 0, log=print) -> dict:
    """Part 3: µs a 1024-row block in each mode (queued; a launch covers
    the 16 blocks) at h = 64 and 128, the products' time at peak, the
    difference from ``full``; beside ``full`` the port's flash forward on
    the same work (B=16, S=1024, one head, non-causal, scale 1) and SDPA
    at scale 1. noexp is timed on column sums of v made before, which its
    end correction reads (their own launch, timed apart as
    ``column_sums``: no part of the flash loop)."""
    rows = {}
    for h in ABLATE_HEAD_DIMS:
        q, k, v = ablation_inputs(h, seed)
        vsum = column_sums(v, BLOCK)
        dots_us = ablate_flops(1, BLOCK, h) / _peak() * 1e6
        row = {}
        for mode in MODES:
            t, late = queued_time(ablate_probe, q, k, v, block=BLOCK, mode=mode, vsum=vsum)
            row[mode] = t / BLOCKS * 1e6
        row["column_sums"] = queued_time(column_sums, v, BLOCK)[0] / BLOCKS * 1e6
        q4, k4, v4 = (t.reshape(BLOCKS, BLOCK, 1, h) for t in (q, k, v))
        t_flash, _ = queued_time(flash.flash_attention, q4, k4, v4, scale=1.0)
        t_sdpa, _ = queued_time(torch.nn.functional.scaled_dot_product_attention,
                                *(t.reshape(BLOCKS, 1, BLOCK, h) for t in (q, k, v)), scale=1.0)
        row.update(flash_fwd=t_flash / BLOCKS * 1e6, sdpa=t_sdpa / BLOCKS * 1e6,
                   dots_at_peak=dots_us)
        rows[h] = row
        for mode in MODES:
            log(f"[flash] part 3, block ablation h={h} {mode}: {row[mode]:.3f} us/block "
                f"(dots would need {dots_us:.3f} us at peak; delta vs full "
                f"{row['full'] - row[mode]:.3f} us)")
        log(f"[flash] part 3, h={h}: the port's flash forward on full's work "
            f"{row['flash_fwd']:.3f} us/block, SDPA {row['sdpa']:.3f} us/block, noexp's column "
            f"sums {row['column_sums']:.3f} us/block apart; softmax share "
            f"of full {(row['full'] - row['dots']) / row['full']:.1%}, of which the "
            f"exponentials {(row['full'] - row['noexp']) / row['full']:.1%}")
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("perf_flash_ceiling measures the card: no CUDA device")
    log = functools.partial(print, flush=True)
    log(f"[flash] {torch.cuda.get_device_name(0)}")
    kernel_bench(log=log)
    composed_8k(log=log)
    ablation(log=log)
    composed_16k(log=log)


if __name__ == "__main__":
    main()
