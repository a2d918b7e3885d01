#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``learning_jax_sharding_tpu_torch/csrc``
(into ``build/torch_kernels/``, one ``nvcc`` per source, in parallel) and
holds each against its plain PyTorch version on the card (decode attention
with float and int8 caches, flash attention, the int4 kernels, the fused
residual+norm forward and backward). Then drives the port's main paths at
the 125M model's full width and depth (seeded random weights): KV-cached
greedy generation in bf16 through ``make_generate_fn``, checked against a
teacher-forced dense forward, with the plain norm, with ``fused_norm=True``
and with ``kv_cache_dtype=torch.int8`` (held to the dense backend over the
same int8 cache); int4 quantized serving of the same model through
``make_generate_fn(dequantize="fused" | "fused_w4a8")`` over
``quantize_tree(bits=4)``, checked against the dense bf16 model on the
dequantized weights, then the decode ladder (bf16, int8, int4-fused,
int4-w4a8); and the train step (flash attention, fused loss, AdamW, b=8,
s=1024, 8 steps per call) through ``make_train_step``, checked for descent
and against the dense attention path, and again with ``fused_norm=True``
against the plain-norm step. Each path's kernel launches are counted from
zero around one run. Times the paths and the kernels, profiles the paths,
and prints the ``kernels`` JSON line, the card's name and power limit, and
last the JSON ``{"ok": true, "device": ...}``. Every phase raises on
failure. Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time

import torch

from learning_jax_sharding_tpu_torch.models.attention import quantize_kv_chunk
from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn
from learning_jax_sharding_tpu_torch.models.quantize import (
    dequantize_leaf_int4,
    dequantize_tree,
    map_unquantized,
    quantize_leaf_int4,
    quantize_tree,
    quantized_bytes,
)
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_125M,
    Transformer,
    fused_next_token_loss,
)
from learning_jax_sharding_tpu_torch.ops import _build
from learning_jax_sharding_tpu_torch.ops import flash_attention as flash
from learning_jax_sharding_tpu_torch.ops import fused_norm as norm_ops
from learning_jax_sharding_tpu_torch.ops import int4_ff as ff4
from learning_jax_sharding_tpu_torch.ops import int4_matmul as mm4
from learning_jax_sharding_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
)
from learning_jax_sharding_tpu_torch.training.loop import adamw
from learning_jax_sharding_tpu_torch.training.pipeline import (
    make_train_step,
    sharded_train_state,
)
from learning_jax_sharding_tpu_torch.utils.bench import (
    device_peak_flops,
    device_peak_hbm_bw,
    mbu,
    mfu,
    time_fn,
)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16: both sides accumulate in fp32, the output rounds to bf16 (2^-8
# relative at |out| ≲ 2).
FLASH_TOL = {
    # fp32: only the order of fp32 sums differs. Grads relative to the
    # largest reference magnitude.
    torch.float32: dict(out=1e-4, lse=1e-4, dq=1e-3, dk=1e-3, dv=1e-3),
    # bf16: p and ds round to bf16 at other points of the online softmax
    # than in the dense plain version (2^-8 relative), outputs round to bf16.
    torch.bfloat16: dict(out=2e-2, lse=2e-2, dq=2e-2, dk=2e-2, dv=2e-2),
}
B, PROMPT, NEW = 8, 128, 128
TF_GAP = 0.1   # teacher-forced: generated token's logit vs the position's max
KERNEL_SOURCE = "learning_jax_sharding_tpu_torch/csrc/decode_attention.cu"
REPLACES = "learning_jax_sharding_tpu/ops/decode_attention.py:83"
FLASH_SOURCE = "learning_jax_sharding_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "fwd": "learning_jax_sharding_tpu/ops/flash_attention.py:175",
    "bwd_dkv": "learning_jax_sharding_tpu/ops/flash_attention.py:314",
    "bwd_dq": "learning_jax_sharding_tpu/ops/flash_attention.py:380",
}
# The train step: bench.py's shape (b=8, s=1024, 8 steps per call).
TRAIN_B, TRAIN_S, K_STEPS, DESCENT_STEPS = 8, 1024, 8, 10
TRAIN_LOSS = dict(
    loss_fn=functools.partial(fused_next_token_loss, chunk_size=128),
    loss_needs_params=True, apply_kwargs={"return_hidden": True},
)
# Flash against dense attention, one bf16 step on the same weights: the two
# round p to bf16 at other points (online vs dense softmax).
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-2, 5e-2
FLASH_SHAPES = {
    "125m_causal": dict(b=8, s=1024, n=12, n_kv=12, h=64, causal=True),
    "case6_noncausal": dict(b=8, s=256, n=8, n_kv=8, h=64, causal=False),
    "gqa_window_h128": dict(b=2, s=512, n=16, n_kv=4, h=128, causal=True, window=128),
    "partial_tile_s200": dict(b=2, s=200, n=4, n_kv=4, h=64, causal=True),
    # S_q < S_kv: keys past the last query get zero dk/dv from empty sweeps.
    "unequal_lengths": dict(b=2, s=192, s_kv=320, n=4, n_kv=4, h=64, causal=True),
}
INT4_SOURCE = "learning_jax_sharding_tpu_torch/csrc/int4_matmul.cu"
INT4_FF_SOURCE = "learning_jax_sharding_tpu_torch/csrc/int4_ff.cu"
INT4_REPLACES = {
    "int4_matmul": "learning_jax_sharding_tpu/ops/int4_matmul.py:59",
    "int4_matmul_w4a8": "learning_jax_sharding_tpu/ops/int4_matmul.py:82",
    "int4_matmul3": "learning_jax_sharding_tpu/ops/int4_matmul.py:65",
    "int4_ff": "learning_jax_sharding_tpu/ops/int4_ff.py:55",
}
# Kernel against plain version, relative to the largest reference magnitude.
INT4_TOL = {
    # fp32: the same products (bf16 weights exact in fp32), summed in
    # another order; |sum| ≤ 3072 terms.
    torch.float32: 1e-5,
    # bf16: both round the same fp32 sums to bf16; a sum order that moves the
    # fp32 value across a rounding boundary flips the last bit: one bf16 ulp,
    # at most 2^-7 of the value.
    torch.bfloat16: 2.0**-7,
}
# bf16 also: the share of outputs whose bf16 bits differ from the plain
# version's. Sum order flips a few in ten thousand; rounding a weight, u or
# the FF's down weights otherwise than the plain version moves every fp32 sum
# by ~2^-9 and flips ~40% (tests/test_torch_quantize.py's misrounding cases),
# a change the 2^-7 bound above cannot see.
INT4_BF16_FLIPS = 0.01
# w4a8: every scale group's int32 partial is exact on both sides and the
# fp32 epilogue runs the same operations in the same order; 1e-6 allows an
# fp32 rounding the compiler may place differently.
W4A8_TOL = 1e-6
# Per-projection int4 sites of the 125M model: (K, N); the FF is (K, H).
INT4_SITES = {"qkv_out": (768, 768), "ff_up": (768, 3072), "ff_down": (3072, 768),
              "lm_head": (768, 50304)}
# Teacher-forced gap of the quantized runs against the dense bf16 model on the
# dequantized weights. int4-fused: the same bf16 weights except the whole-FF
# kernel, which keeps the hidden activation and down weights in fp32 where
# the dense model rounds them to bf16 (2^-9 relative): TF_GAP's 0.1 holds.
# w4a8 rounds every projection input to int8 per row: one step of amax/127
# for the whole row, where bf16 steps by 2^-8 of each element, so a typical
# element (a few times below the row's max) rounds several times more
# coarsely, in all 73 projections of a forward; the bound is 3× TF_GAP.
QUANT_TF_GAP = {"fused": 0.1, "fused_w4a8": 0.3}
LADDER_ROUNDS = 3
NORM_SOURCE = "learning_jax_sharding_tpu_torch/csrc/fused_norm.cu"
NORM_REPLACES = {"fwd": "learning_jax_sharding_tpu/ops/fused_norm.py:57",
                 "bwd": "learning_jax_sharding_tpu/ops/fused_norm.py:82"}
# Row counts at M=768: the train step (b=8 × s=1024), a prefill of 8 × 128,
# a decode step of 8 rows, and one that is not a power of two.
NORM_ROWS = {"train": TRAIN_B * TRAIN_S, "prefill": B * PROMPT, "decode": B, "odd": 37}
NORM_CASES = [  # kind, residual, beta
    ("layernorm", True, True), ("layernorm", False, True), ("layernorm", True, False),
    ("rmsnorm", True, False), ("rmsnorm", False, False),
]
# Fused norm against its plain version, relative to the largest reference
# magnitude. fp32: the row sums (mean, variance, c1, c2) and the dgamma/dbeta
# column sums run in another order. bf16 outputs: both round the same fp32
# value up to that order, one bf16 ulp (2^-7 of the value) at most, and the
# share of differing outputs must stay under INT4_BF16_FLIPS (normalising the
# rounded residual, or adding dr to an unrounded dx, flips ~20% of them).
# The new residual is one rounding of the same fp32 sum: bit-equal.
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def int8_kv(gen, *shape):
    """A seeded float cache (or new-token chunk) quantized as the cache
    stores it → (int8 values, fp32 per-(token, head) scales)."""
    scale, q = quantize_kv_chunk(torch.randn(*shape, generator=gen, device="cuda"))
    return q.to(torch.int8), scale


def kernel_case(name, gen, dtype, *, b, s, n, n_kv, h, length, index,
                window=None, fold=False, write_enable=None, int8=False):
    """One kernel-vs-plain comparison on the card → max abs error. ``int8``:
    quantized caches with their scales (and new-token scales when folded)."""
    q = randn(gen, b, s, n, h, dtype=dtype)
    kw = dict(window=window)
    if int8:
        kc, ks = int8_kv(gen, b, n_kv, length, h)
        vc, vs = int8_kv(gen, b, n_kv, length, h)
        caches = {"k_cache": kc, "v_cache": vc, "k_scale": ks, "v_scale": vs}
    else:
        caches = {"k_cache": randn(gen, b, n_kv, length, h, dtype=dtype),
                  "v_cache": randn(gen, b, n_kv, length, h, dtype=dtype)}
    new = {}
    if fold:
        if int8:
            (new["k_new"], new["ks_new"]), (new["v_new"], new["vs_new"]) = (
                int8_kv(gen, b, n_kv, 1, h) for _ in range(2))
        else:
            new = {"k_new": randn(gen, b, n_kv, 1, h, dtype=dtype),
                   "v_new": randn(gen, b, n_kv, 1, h, dtype=dtype)}
        kw.update(new, write_enable=write_enable)
    before = {k: v.clone() for k, v in caches.items()}
    ref_caches = {k: v.clone() for k, v in caches.items()}
    scales = {k: caches[k] for k in ("k_scale", "v_scale") if k in caches}
    ref_scales = {k: ref_caches[k] for k in scales}
    out = decode_attention(q, caches["k_cache"], caches["v_cache"], index, **scales, **kw)
    ref = decode_attention_reference(q, ref_caches["k_cache"], ref_caches["v_cache"], index,
                                     **ref_scales, **kw)
    torch.cuda.synchronize()
    if fold:
        out, ref = out[0], ref[0]
        for key in caches:
            if not torch.equal(caches[key], ref_caches[key]):
                raise AssertionError(f"{name}: folded write of {key} differs from the plain "
                                     f"version")
        idx = index.expand(b).tolist()
        enabled = [True] * b if write_enable is None else [bool(e) for e in write_enable.tolist()]
        written = {"k_cache": "k_new", "v_cache": "v_new", "k_scale": "ks_new",
                   "v_scale": "vs_new"}
        for row in range(b):
            for key, buf in caches.items():
                if enabled[row]:
                    if not torch.equal(buf[row, :, idx[row]], new[written[key]][row, :, 0]):
                        raise AssertionError(f"{name}: row {row} slot of {key} not written")
                elif not torch.equal(buf[row], before[key][row]):
                    raise AssertionError(f"{name}: disabled row {row} {key} changed")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    label = f"{name}{' int8' if int8 else ''}"
    log(f"[kernel] {label} {str(dtype)[6:]}: max abs err {err:.3e} (tol {TOL[dtype]:g})")
    if err > TOL[dtype]:
        raise AssertionError(f"{label} {dtype}: max abs err {err} > {TOL[dtype]}")
    return err


def check_kernel(gen, *, int8=False):
    """Decode attention against its plain version at the 125M prefill
    (S=128) and decode (S=1, index 200) shapes, a ragged folded write with
    one row disabled, and GQA + window at H=128; float caches, or int8
    ones with their scales."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        mha = dict(b=B, n=12, n_kv=12, h=64, length=1024, int8=int8)
        row_index = torch.randint(0, 1000, (B,), generator=gen, device="cuda",
                                  dtype=torch.int32)
        enable = torch.ones(B, dtype=torch.int32, device="cuda")
        enable[B // 2] = 0
        zero = torch.zeros((), dtype=torch.int32, device="cuda")
        cases = [
            kernel_case("prefill", gen, dtype, s=PROMPT, index=zero, **mha),
            kernel_case("decode", gen, dtype, s=1, index=zero + 200, **mha),
            kernel_case("ragged_fold", gen, dtype, s=1, index=row_index, fold=True,
                        write_enable=enable, **mha),
            kernel_case("gqa_window", gen, dtype, b=4, s=64, n=16, n_kv=4, h=128,
                        length=1024, index=zero + 300, window=64, int8=int8),
        ]
        if int8:
            cases.append(kernel_case("decode_fold", gen, dtype, s=1, index=zero + 200,
                                     fold=True, **mha))
        errs[dtype] = max(cases)
    return errs


def norm_inputs(gen, rows, dtype, param_dtype, resid, beta, m=768):
    """Seeded fused-norm inputs and cotangents (``dr`` with a residual)."""
    t = {"x": randn(gen, rows, m, dtype=dtype), "dy": randn(gen, rows, m, dtype=dtype)}
    t["res"] = randn(gen, rows, m, dtype=dtype) if resid else None
    t["dr"] = randn(gen, rows, m, dtype=dtype) if resid else None
    t["g"] = (1 + 0.1 * torch.randn(m, generator=gen, device="cuda")).to(param_dtype)
    t["b"] = (0.1 * torch.randn(m, generator=gen, device="cuda")).to(param_dtype) if beta else None
    return t


def check_fused_norm(gen):
    """The fused-norm kernels against their plain versions on the card, in
    fp32 and bf16, at every ``NORM_ROWS`` count and ``NORM_CASES`` kind; bf16
    rows also with bf16 parameters (generation casts them). Forward with and
    without the statistics; backward from the plain forward's statistics,
    with ``dr`` when there is a residual → per kernel and dtype the largest
    relative (checked) and absolute error and differing bf16 share."""
    worst = {}

    def note(kernel, dtype, label, name, got, want, tol):
        errs = rel_err(f"{label} {name}", got, want)
        old = worst.get((kernel, dtype), (0.0, 0.0, 0.0))
        worst[kernel, dtype] = tuple(map(max, old, errs))
        if not errs[0] <= tol:
            raise AssertionError(f"fused_norm {label} {name}: relative error {errs[0]} > {tol}")
        if want.dtype == torch.bfloat16 and not errs[2] <= INT4_BF16_FLIPS:
            raise AssertionError(f"fused_norm {label} {name}: {errs[2]} of bf16 outputs differ "
                                 f"from the plain version's > {INT4_BF16_FLIPS}")
        return errs

    for dtype in (torch.float32, torch.bfloat16):
        for rows_name, rows in NORM_ROWS.items():
            params = [torch.float32] + ([torch.bfloat16] if dtype == torch.bfloat16
                                        and rows_name in ("prefill", "decode") else [])
            for param_dtype in params:
                for kind, resid, beta in NORM_CASES:
                    t = norm_inputs(gen, rows, dtype, param_dtype, resid, beta)
                    label = (f"{rows_name} {rows}x768 {kind}{' +resid' if resid else ''}"
                             f"{' +beta' if beta else ''} {str(dtype)[6:]}/{str(param_dtype)[6:]}")
                    args = (t["x"], t["res"], t["g"], t["b"])
                    kw = dict(eps=1e-6, kind=kind)
                    ref = norm_ops.fused_residual_norm_reference(*args, **kw, needs_stats=True)
                    errs = []
                    for stats in (True, False):
                        got = norm_ops._fwd(*args, **kw, needs_stats=stats)
                        errs.append(note("fwd", dtype, label, "y", got[0], ref[0],
                                         NORM_TOL[dtype]))
                        if resid and not torch.equal(got[1], ref[1]):
                            raise AssertionError(f"fused_norm {label}: new residual differs")
                        if stats:
                            for name, g, w in (("mean", got[2], ref[2]), ("rstd", got[3], ref[3])):
                                if w is not None:
                                    note("fwd", torch.float32, label, name, g, w,
                                         NORM_TOL[torch.float32])
                    r_full = ref[1] if resid else t["x"]
                    bwd_args = (t["dy"], r_full, t["g"], ref[2], ref[3], t["dr"])
                    bkw = dict(kind=kind, has_beta=beta)
                    got = norm_ops._bwd(*bwd_args, **bkw)
                    want = norm_ops.fused_residual_norm_bwd_reference(*bwd_args, **bkw)
                    errs.append(note("bwd", dtype, label, "dx", got[0], want[0], NORM_TOL[dtype]))
                    # dgamma/dbeta: fp32 column sums, cast to gamma's dtype.
                    for name, g, w in (("dgamma", got[1], want[1]), ("dbeta", got[2], want[2])):
                        if w is not None:
                            note("bwd", param_dtype, label, name, g, w, NORM_TOL[param_dtype])
                    flips = (f"; differing bf16 outputs {max(e[2] for e in errs):.2e} "
                             f"(limit {INT4_BF16_FLIPS:g})" if dtype == torch.bfloat16 else "")
                    log(f"[norm] {label}: y {errs[0][0]:.2e} (no stats {errs[1][0]:.2e}), dx "
                        f"{errs[2][0]:.2e} of the largest |ref|{flips}")
    torch.cuda.synchronize()
    return worst


def fold_rows(x, group):
    """``(B, S, N, H)`` → the kernels' ``(B·N_kv, S·group, H)`` rows."""
    b, s, n, h = x.shape
    return (x.reshape(b, s, n // group, group, h).permute(0, 2, 1, 3, 4)
            .reshape(b * n // group, s * group, h).contiguous())


def flash_case(name, gen, dtype, *, b, s, n, n_kv, h, causal, window=None, s_kv=None):
    """The three flash kernels against their plain versions on one shape →
    errors: fwd ``out``/``lse`` absolute, bwd grads relative to the largest
    reference magnitude. The backward pair gets the plain forward's
    ``out``/``lse``, so each kernel is held on the same inputs."""
    group, s_kv = n // n_kv, s if s_kv is None else s_kv
    q = fold_rows(randn(gen, b, s, n, h, dtype=dtype), group)
    k = fold_rows(randn(gen, b, s_kv, n_kv, h, dtype=dtype), 1)
    v = fold_rows(randn(gen, b, s_kv, n_kv, h, dtype=dtype), 1)
    do = randn(gen, *q.shape, dtype=dtype)
    kw = dict(scale=h**-0.5, causal=causal, window=window, group=group)
    out, lse = flash._fwd(q, k, v, kw["scale"], causal, window, group)
    ref_out, ref_lse = flash.flash_attention_fwd_reference(q, k, v, **kw)
    grads = flash._bwd(q, k, v, ref_out, ref_lse, do, kw["scale"], causal, window, group)
    ref_grads = flash.flash_attention_bwd_reference(q, k, v, ref_out, ref_lse, do, **kw)
    torch.cuda.synchronize()
    errs = {
        "out": (out.float() - ref_out.float()).abs().max().item(),
        "lse": (lse - ref_lse).abs().max().item(),
    }
    abs_errs = dict(errs)
    for gname, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash {name} {dtype}: non-finite {gname}")
        abs_errs[gname] = (got.float() - want.float()).abs().max().item()
        errs[gname] = abs_errs[gname] / want.float().abs().max().item()
    tol = FLASH_TOL[dtype]
    log(f"[flash] {name} {str(dtype)[6:]}: " + ", ".join(
        f"{k} {v:.3e} (tol {tol[k]:g})" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= tol[k]}
    if bad:
        raise AssertionError(f"flash {name} {dtype}: errors {bad} over {tol}")
    return errs, abs_errs


def check_flash(gen):
    """``FLASH_SHAPES`` in fp32 and bf16: (a) the 125M train step, (b)
    non-causal (case6), (c) GQA + window at H=128 (fully masked rows at tile
    edges), (d) a partial tile, (e) unequal q/kv lengths → the largest error
    of each kernel per dtype, as checked and absolute."""
    outputs = {"fwd": ("out", "lse"), "bwd_dkv": ("dk", "dv"), "bwd_dq": ("dq",)}
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        cases = [flash_case(name, gen, dtype, **kw) for name, kw in FLASH_SHAPES.items()]
        for which, idx in (("checked", 0), ("abs", 1)):
            worst[dtype, which] = {
                kernel: max(c[idx][o] for c in cases for o in outs)
                for kernel, outs in outputs.items()
            }
    return worst


def teacher_forced_gap(model, out, starts, ends):
    """Largest gap between a generated token's logit and the max logit at
    its position, under the dense (non-decode) forward."""
    with torch.no_grad():
        logits = model(out).float()
    if not torch.isfinite(logits).all():
        raise AssertionError("teacher-forced logits are not finite")
    gap = 0.0
    for row in range(out.shape[0]):
        pos = torch.arange(starts[row], ends[row], device=out.device)
        lg = logits[row, pos - 1]
        chosen = lg.gather(1, out[row, pos].long()[:, None])[:, 0]
        gap = max(gap, (lg.amax(-1) - chosen).max().item())
    return gap


def check_output(out, b, total, vocab):
    if out.shape != (b, total) or out.dtype != torch.int32:
        raise AssertionError(f"output {tuple(out.shape)} {out.dtype}, want ({b}, {total}) int32")
    if int(out.min()) < 0 or int(out.max()) >= vocab:
        raise AssertionError("output token ids out of range")


def run_main_path(params, gen, tf_model, card):
    """Rectangular and ragged+EOS generation through make_generate_fn."""
    vocab = CONFIG_125M.vocab_size
    prompt = torch.randint(0, vocab, (B, PROMPT), generator=gen, device="cuda",
                           dtype=torch.int32)
    rect = make_generate_fn(CONFIG_125M, max_new_tokens=NEW, inference_dtype=torch.bfloat16)
    rect(params, prompt)                                     # warm-up
    torch.cuda.synchronize()
    decode_attention.launches = 0
    out = rect(params, prompt)
    torch.cuda.synchronize()
    rect_launches = decode_attention.launches
    want = CONFIG_125M.num_layers * NEW
    log(f"[main] rectangular b={B} prompt {PROMPT} +{NEW}: {rect_launches} kernel launches (want {want})")
    if rect_launches != want:
        raise AssertionError(f"rectangular run launched the kernel {rect_launches} times, want {want}")
    check_output(out, B, PROMPT + NEW, vocab)
    gap = teacher_forced_gap(tf_model, out, [PROMPT] * B, [PROMPT + NEW] * B)
    log(f"[main] rectangular teacher-forced max gap {gap:.4f} (limit {TF_GAP})")
    if gap > TF_GAP:
        raise AssertionError(f"rectangular teacher-forced gap {gap} > {TF_GAP}")

    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rect(params, prompt)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    sec = sorted(secs)[1]
    tok_s = B * NEW / sec
    log(f"[time] 125M generate b={B} prompt {PROMPT} +{NEW} bf16: {tok_s:.1f} tok/s, "
        f"{sec / NEW * 1e3:.3f} ms/token-step (median of 3: {[round(s, 4) for s in secs]}) on {card}")

    lengths = torch.randint(32, PROMPT + 1, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
    ragged_prompt = prompt.clone()
    cols = torch.arange(PROMPT, device="cuda")[None, :]
    ragged_prompt[cols >= lengths[:, None]] = 0
    plain = make_generate_fn(CONFIG_125M, max_new_tokens=NEW, inference_dtype=torch.bfloat16,
                             ragged=True)(params, ragged_prompt, lengths=lengths)
    eos = int(plain[0, int(lengths[0]) + 3])               # row 0's 4th new token
    ragged = make_generate_fn(CONFIG_125M, max_new_tokens=NEW, inference_dtype=torch.bfloat16,
                              ragged=True, eos_id=eos)
    decode_attention.launches = 0
    out_r = ragged(params, ragged_prompt, lengths=lengths)
    torch.cuda.synchronize()
    ragged_launches = decode_attention.launches
    log(f"[main] ragged+eos b={B} lengths {lengths.tolist()} eos {eos}: "
        f"{ragged_launches} kernel launches")
    if ragged_launches == 0:
        raise AssertionError("ragged run never launched the kernel")
    check_output(out_r, B, PROMPT + NEW, vocab)
    starts, ends = lengths.tolist(), []
    for row, start in enumerate(starts):
        span = out_r[row, start : start + NEW]
        hits = (span == eos).nonzero()
        ends.append(start + (int(hits[0]) + 1 if len(hits) else NEW))
    gap_r = teacher_forced_gap(tf_model, out_r, starts, ends)
    log(f"[main] ragged teacher-forced max gap {gap_r:.4f} over spans {[e - s for s, e in zip(starts, ends)]}")
    if gap_r > TF_GAP:
        raise AssertionError(f"ragged teacher-forced gap {gap_r} > {TF_GAP}")
    return dict(rect_launches=rect_launches, ragged_launches=ragged_launches,
                tok_s=tok_s, ms_per_step=sec / NEW * 1e3, gap=max(gap, gap_r))


def profile_summary(label, run, steps, ms_per_step):
    """Where a step's time goes: ``run()`` (``steps`` steps) once under
    torch.profiler → device kernels per step, device-busy time per step, the
    idle share against the unprofiled ms/step, and the top 6 kernels."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # Device activity without the ranges that annotations (such as the
    # optimizer's step) draw over the kernels they enclose.
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise AssertionError(f"{label}: the profiler saw no device kernels")
    busy_us, by_name = 0.0, Counter()
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        busy_us += dur
        by_name[e.name] += dur
    busy_ms = busy_us / 1e3 / steps
    top = [(name[:60], round(us / 1e3 / steps, 4)) for name, us in by_name.most_common(6)]
    row = dict(kernels_per_step=len(kernels) / steps, busy_ms_per_step=busy_ms,
               idle_share=1 - busy_ms / ms_per_step, top_ms_per_step=top)
    log(f"[profile] {label}, per step: {row['kernels_per_step']:.1f} device kernels, "
        f"device busy {busy_ms:.3f} ms of {ms_per_step:.3f} ms unprofiled "
        f"(idle share {row['idle_share']:.3f}); top: {top}")
    return row


def profile_generate(params, gen, ms_per_step):
    """One rectangular generate call under the profiler, per token step."""
    prompt = torch.randint(0, CONFIG_125M.vocab_size, (B, PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    rect = make_generate_fn(CONFIG_125M, max_new_tokens=NEW, inference_dtype=torch.bfloat16)
    rect(params, prompt)
    torch.cuda.synchronize()
    return profile_summary("125M generate token step", lambda: rect(params, prompt),
                           NEW, ms_per_step)


def train_batch(gen, vocab):
    """One seeded (b, s) batch: inputs and the targets shifted by one."""
    tokens = torch.randint(0, vocab, (TRAIN_B, TRAIN_S + 1), generator=gen, device="cuda")
    return {"inputs": tokens[:, :-1].contiguous(), "targets": tokens[:, 1:].contiguous()}


def step_check(batch, variants=None):
    """One bf16 loss and gradient of the 125M model through two variants of
    its config, from the same seeded weights → both losses, their
    difference, and the worst relative Frobenius error of a parameter's
    gradient. Default: the flash kernels against the dense attention path
    (``attn_fn=None``)."""
    if variants is None:
        variants = {"flash": dict(attn_fn=flash.make_flash_attn_fn()), "dense": dict(attn_fn=None)}
    (a, b) = variants
    losses, grads = {}, {}
    for name, fields in variants.items():
        model = Transformer(dataclasses.replace(CONFIG_125M, **fields), device="cuda", seed=0)
        hidden = model(batch["inputs"], return_hidden=True)
        loss = fused_next_token_loss(hidden, batch, model, chunk_size=128)
        loss.backward()
        losses[name] = loss.item()
        grads[name] = {n: p.grad for n, p in model.named_parameters()}
        del model, hidden, loss
    loss_err = abs(losses[a] - losses[b])
    rel = {n: ((g - grads[b][n]).norm() / grads[b][n].norm()).item()
           for n, g in grads[a].items()}
    worst = max(rel, key=rel.get)
    log(f"[train] {a} vs {b}, one step: loss {losses[a]:.6f} vs {losses[b]:.6f} (diff "
        f"{loss_err:.2e}, tol {STEP_LOSS_TOL:g}); worst grad rel Frobenius err "
        f"{rel[worst]:.3e} ({worst}, tol {STEP_GRAD_TOL:g})")
    if not loss_err <= STEP_LOSS_TOL:
        raise AssertionError(f"{a} vs {b} loss differ by {loss_err}")
    if not rel[worst] <= STEP_GRAD_TOL:
        raise AssertionError(f"{a} vs {b} grad of {worst} differs by {rel[worst]}")
    return {f"loss_{a}": losses[a], f"loss_{b}": losses[b], "loss_diff": loss_err,
            "worst_grad_rel_err": rel[worst], "worst_grad": worst}


def run_train_path(gen, card):
    """The 125M train step through ``make_train_step``: descent over 10
    steps on one batch, the kernel launches of one 8-step call, its time."""
    cfg = dataclasses.replace(CONFIG_125M, attn_fn=flash.make_flash_attn_fn())
    state = sharded_train_state(Transformer(cfg, device="cuda", seed=0), adamw(3e-4))
    batch = train_batch(gen, cfg.vocab_size)

    step = make_train_step(**TRAIN_LOSS)
    losses = torch.stack([step(state, batch)[1] for _ in range(DESCENT_STEPS)]).tolist()
    log(f"[train] {DESCENT_STEPS} steps on one batch, losses {[round(x, 4) for x in losses]}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not descend: {losses}")

    multi = make_train_step(steps_per_call=K_STEPS, **TRAIN_LOSS)
    stacked = {k: v.expand(K_STEPS, *v.shape) for k, v in batch.items()}
    multi(state, stacked)                                   # warm-up
    torch.cuda.synchronize()
    flash.flash_attention.launches = dict.fromkeys(flash.flash_attention.launches, 0)
    _, call_losses = multi(state, stacked)
    torch.cuda.synchronize()
    launches = dict(flash.flash_attention.launches)
    want = K_STEPS * cfg.num_layers
    log(f"[main] 125M train step, one {K_STEPS}-step call: launches {launches} (want {want} each)")
    if launches != dict.fromkeys(launches, want):
        raise AssertionError(f"one {K_STEPS}-step call launched {launches}, want {want} each")
    if call_losses.shape != (K_STEPS,) or not torch.isfinite(call_losses).all():
        raise AssertionError(f"the {K_STEPS}-step call returned {call_losses}")

    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multi(state, stacked)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    step_s = sorted(secs)[1] / K_STEPS
    flops = cfg.train_step_flops(TRAIN_B, TRAIN_S)
    row = dict(launches=launches, descent_losses=losses, ms_per_step=step_s * 1e3,
               tok_s=TRAIN_B * TRAIN_S / step_s, mfu=mfu(flops, step_s),
               flops_per_step=flops, call_seconds=secs)
    log(f"[time] 125M train step b={TRAIN_B} s={TRAIN_S} bf16, flash + fused loss + AdamW: "
        f"{row['ms_per_step']:.3f} ms/step, {row['tok_s']:.1f} tok/s, MFU {row['mfu']:.4f} "
        f"({flops / 1e12:.3f} TFLOP/step; median of 3 {K_STEPS}-step calls: "
        f"{[round(x, 4) for x in secs]} s) on {card}")
    row["profile"] = profile_summary(
        f"125M train step ({K_STEPS}-step call)", lambda: multi(state, stacked),
        K_STEPS, row["ms_per_step"])
    del state
    return row


def norm_calls(cfg) -> int:
    """Fused-norm calls of one forward: ``ln_attn`` and ``ln_ff`` per block,
    and ``ln_out``."""
    return 2 * cfg.num_layers + 1


def reset_norm_launches() -> None:
    norm_ops.fused_residual_norm.launches = dict.fromkeys(norm_ops.fused_residual_norm.launches, 0)


def run_fused_train_path(gen, card):
    """The 125M train step with ``fused_norm=True`` (flash attention, fused
    loss, AdamW) through ``make_train_step``: descent over 10 steps on one
    batch; one step against the plain-norm step on the same weights; the
    fused-norm and flash launches of one 8-step call; its time interleaved
    with the plain-norm step's (every round times each once; medians of 3);
    a profile."""
    flash_fn = flash.make_flash_attn_fn()
    batch = train_batch(gen, CONFIG_125M.vocab_size)
    check = step_check(batch, {"fused_norm": dict(attn_fn=flash_fn, fused_norm=True),
                               "plain_norm": dict(attn_fn=flash_fn)})
    torch.cuda.empty_cache()
    states = {name: sharded_train_state(
        Transformer(dataclasses.replace(CONFIG_125M, attn_fn=flash_fn, fused_norm=fused),
                    device="cuda", seed=0), adamw(3e-4))
        for name, fused in (("plain_norm", False), ("fused_norm", True))}
    step = make_train_step(**TRAIN_LOSS)
    losses = torch.stack([step(states["fused_norm"], batch)[1]
                          for _ in range(DESCENT_STEPS)]).tolist()
    log(f"[train] fused_norm: {DESCENT_STEPS} steps on one batch, losses "
        f"{[round(x, 4) for x in losses]}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite fused-norm train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the fused-norm loss did not descend: {losses}")

    multi = make_train_step(steps_per_call=K_STEPS, **TRAIN_LOSS)
    stacked = {k: v.expand(K_STEPS, *v.shape) for k, v in batch.items()}
    for state in states.values():
        multi(state, stacked)                               # warm-up
    torch.cuda.synchronize()
    reset_norm_launches()
    flash.flash_attention.launches = dict.fromkeys(flash.flash_attention.launches, 0)
    _, call_losses = multi(states["fused_norm"], stacked)
    torch.cuda.synchronize()
    norm = dict(norm_ops.fused_residual_norm.launches)
    flash_launches = dict(flash.flash_attention.launches)
    # 25 norms a step at 125M: two per block (ln_ff with the residual) and ln_out.
    per_call = norm_calls(CONFIG_125M) * K_STEPS
    want_norm = {"fwd": per_call, "fwd_nostats": 0, "bwd": per_call}
    want_flash = K_STEPS * CONFIG_125M.num_layers
    log(f"[main] 125M train step, fused_norm, one {K_STEPS}-step call: fused-norm launches "
        f"{norm} (want {want_norm}), flash {flash_launches} (want {want_flash} each)")
    if norm != want_norm:
        raise AssertionError(f"one fused-norm {K_STEPS}-step call launched {norm}, want {want_norm}")
    if flash_launches != dict.fromkeys(flash_launches, want_flash):
        raise AssertionError(f"one fused-norm {K_STEPS}-step call launched flash {flash_launches}")
    if call_losses.shape != (K_STEPS,) or not torch.isfinite(call_losses).all():
        raise AssertionError(f"the fused-norm {K_STEPS}-step call returned {call_losses}")

    secs = interleaved_seconds(
        {name: functools.partial(multi, state, stacked) for name, state in states.items()})
    flops = CONFIG_125M.train_step_flops(TRAIN_B, TRAIN_S)
    timing = {}
    for name, calls in secs.items():
        step_s = statistics.median(calls) / K_STEPS
        timing[name] = dict(ms_per_step=step_s * 1e3, tok_s=TRAIN_B * TRAIN_S / step_s,
                            mfu=mfu(flops, step_s), call_seconds=calls)
        log(f"[time] 125M train step b={TRAIN_B} s={TRAIN_S} bf16, flash + fused loss + AdamW, "
            f"{name} (interleaved): {timing[name]['ms_per_step']:.3f} ms/step, "
            f"{timing[name]['tok_s']:.1f} tok/s, MFU {timing[name]['mfu']:.4f} (median of 3 "
            f"{K_STEPS}-step calls: {[round(x, 4) for x in calls]} s) on {card}")
    profile = profile_summary(
        f"125M train step, fused_norm ({K_STEPS}-step call)",
        lambda: multi(states["fused_norm"], stacked), K_STEPS,
        timing["fused_norm"]["ms_per_step"])
    del states
    return dict(launches=norm, flash_launches=flash_launches, descent_losses=losses,
                step_check=check, timing=timing, profile=profile)


def run_fused_generate(params, gen, tf_model, card):
    """125M generation with ``fused_norm=True`` (b=8, prompt 128, +128,
    bf16): every norm through the no-statistics forward, counted from zero
    around one rectangular call; teacher-forced against the fused-norm
    dense forward (and, reported, the plain-norm one); timed interleaved
    with the plain-norm generate (medians of 3)."""
    cfg = dataclasses.replace(CONFIG_125M, fused_norm=True)
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda",
                           dtype=torch.int32)
    fns = {name: make_generate_fn(c, max_new_tokens=NEW, inference_dtype=torch.bfloat16)
           for name, c in (("plain_norm", CONFIG_125M), ("fused_norm", cfg))}
    for fn in fns.values():
        fn(params, prompt)                                  # warm-up
    torch.cuda.synchronize()
    reset_norm_launches()
    decode_attention.launches = 0
    out = fns["fused_norm"](params, prompt)
    torch.cuda.synchronize()
    norm = dict(norm_ops.fused_residual_norm.launches)
    want = {"fwd": 0, "fwd_nostats": norm_calls(cfg) * NEW, "bwd": 0}
    log(f"[main] 125M generate, fused_norm, b={B} prompt {PROMPT} +{NEW}: fused-norm launches "
        f"{norm} (want {want}), decode attention {decode_attention.launches}")
    if norm != want:
        raise AssertionError(f"fused-norm generate launched {norm}, want {want}")
    if decode_attention.launches != CONFIG_125M.num_layers * NEW:
        raise AssertionError(f"fused-norm generate launched decode attention "
                             f"{decode_attention.launches} times")
    check_output(out, B, PROMPT + NEW, cfg.vocab_size)
    fused_tf = Transformer(dataclasses.replace(cfg, param_dtype=torch.bfloat16), device="cuda",
                           seed=1).eval()
    fused_tf.load_state_dict(params)
    span = ([PROMPT] * B, [PROMPT + NEW] * B)
    gap = teacher_forced_gap(fused_tf, out, *span)
    gap_plain = teacher_forced_gap(tf_model, out, *span)
    del fused_tf
    log(f"[main] fused_norm teacher-forced max gap {gap:.4f} (limit {TF_GAP}) against the "
        f"fused-norm dense forward; {gap_plain:.4f} against the plain-norm one (reported)")
    if gap > TF_GAP:
        raise AssertionError(f"fused-norm teacher-forced gap {gap} > {TF_GAP}")
    timing = interleaved_generate(fns, {name: params for name in fns}, prompt, card,
                                  "125M generate bf16")
    return dict(launches=norm, teacher_forced_max_gap=gap, plain_norm_tf_gap=gap_plain,
                timing=timing)


def interleaved_seconds(calls: dict, rounds: int = 3) -> dict:
    """Host seconds of each synchronised call, every round running each call
    once in turn (no variant always runs first after another's work)."""
    times = {name: [] for name in calls}
    for _ in range(rounds):
        for name, call in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    return times


def interleaved_generate(fns, trees, prompt, card, label):
    """Each generate function once per round, 3 rounds → per function tok/s
    and ms per token step (medians)."""
    times = interleaved_seconds(
        {name: functools.partial(fn, trees[name], prompt) for name, fn in fns.items()})
    rows = {}
    for name, secs in times.items():
        sec = statistics.median(secs)
        rows[name] = dict(tok_s=B * NEW / sec, ms_per_token_step=sec / NEW * 1e3, seconds=secs)
        log(f"[time] {label} b={B} prompt {PROMPT} +{NEW}, {name} (interleaved): "
            f"{rows[name]['tok_s']:.1f} tok/s, {rows[name]['ms_per_token_step']:.3f} "
            f"ms/token-step (median of 3: {[round(x, 4) for x in secs]} s) on {card}")
    return rows


def kv_cache_bytes(cfg, store_bytes: int, scale_bytes: int) -> int:
    """Bytes of the decode caches ``make_generate_fn`` allocates for b=8:
    k and v at the full ``max_seq_len`` in every layer, plus their scales."""
    n_kv = cfg.num_kv_heads or cfg.num_heads
    slots = cfg.num_layers * B * n_kv * cfg.max_seq_len
    return 2 * slots * (cfg.head_dim * store_bytes + scale_bytes)


def run_int8_generate(params, gen, card):
    """125M generation with ``kv_cache_dtype=torch.int8`` (b=8, prompt 128,
    +128, bf16 compute): decode attention's int8 mode, counted from zero
    around one rectangular call; teacher-forced against the port's
    dense-backend forward over the same int8 cache (one prefill of the
    whole sequence: both sides quantize with ``quantize_kv_chunk``); timed
    interleaved with the bf16-cache generate, with each run's cache bytes."""
    cfg = dataclasses.replace(CONFIG_125M, kv_cache_dtype=torch.int8)
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda",
                           dtype=torch.int32)
    fns = {name: make_generate_fn(c, max_new_tokens=NEW, inference_dtype=torch.bfloat16)
           for name, c in (("bf16_cache", CONFIG_125M), ("int8_cache", cfg))}
    for fn in fns.values():
        fn(params, prompt)                                  # warm-up
    torch.cuda.synchronize()
    decode_attention.launches = 0
    out = fns["int8_cache"](params, prompt)
    torch.cuda.synchronize()
    launches = decode_attention.launches
    want = cfg.num_layers * NEW
    log(f"[main] 125M generate, int8 KV cache, b={B} prompt {PROMPT} +{NEW}: {launches} decode "
        f"attention launches (want {want})")
    if launches != want:
        raise AssertionError(f"int8-cache generate launched the kernel {launches} times, want {want}")
    check_output(out, B, PROMPT + NEW, cfg.vocab_size)
    dense = Transformer(dataclasses.replace(cfg, decode=True, decode_attention="dense",
                                            dtype=torch.bfloat16, param_dtype=torch.bfloat16),
                        device="cuda", seed=1).eval()
    dense.load_state_dict(params)
    gap = teacher_forced_gap(lambda t: dense(t, cache=dense.init_cache(t.shape[0])), out,
                             [PROMPT] * B, [PROMPT + NEW] * B)
    del dense
    log(f"[main] int8 KV cache teacher-forced max gap {gap:.4f} against the dense-backend "
        f"forward over an int8 cache (limit {TF_GAP})")
    if gap > TF_GAP:
        raise AssertionError(f"int8-cache teacher-forced gap {gap} > {TF_GAP}")
    timing = interleaved_generate(fns, {name: params for name in fns}, prompt, card,
                                  "125M generate bf16 compute")
    timing["bf16_cache"]["cache_bytes"] = kv_cache_bytes(cfg, 2, 0)
    timing["int8_cache"]["cache_bytes"] = kv_cache_bytes(cfg, 1, 4)
    log(f"[main] KV cache bytes at b={B}, {cfg.max_seq_len} slots: bf16 "
        f"{timing['bf16_cache']['cache_bytes'] / 1e6:.2f} MB, int8 + fp32 scales "
        f"{timing['int8_cache']['cache_bytes'] / 1e6:.2f} MB")
    return dict(launches=launches, teacher_forced_max_gap=gap, timing=timing)


def bound(nbytes, ops, peak=None):
    """The least time the card takes: bytes over its memory rate or
    operations over its peak for their type (default bf16), whichever is
    larger (ms, and which)."""
    t_bytes = nbytes / (device_peak_hbm_bw() or 3.35e12) * 1e3
    t_ops = ops / (peak or device_peak_flops() or 989e12) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_flash(gen, card):
    """Each flash kernel, the plain versions and SDPA at the train step's
    attention shape: folded q (96, 1024, 64) bf16, causal."""
    b, s, n, h, scale = TRAIN_B, TRAIN_S, 12, 64, 64**-0.5
    q, k, v, do = (fold_rows(randn(gen, b, s, n, h, dtype=torch.bfloat16), 1)
                   for _ in range(4))
    out, lse = flash._fwd(q, k, v, scale, True, None, 1)
    delta = flash._delta(out, do)
    dq, dk, dv, out2, lse2 = map(torch.empty_like, (q, k, v, out, lse))
    common = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    args = (q, k, scale, True, None, 1)
    kernels = {
        "fwd": lambda: flash._launch("fwd", [t.data_ptr() for t in (q, k, v, out2, lse2)], *args),
        "bwd_dkv": lambda: flash._launch("bwd_dkv", common + [dk.data_ptr(), dv.data_ptr()], *args),
        "bwd_dq": lambda: flash._launch("bwd_dq", common + [dq.data_ptr()], *args),
    }
    kw = dict(scale=scale, causal=True)
    plain_fwd = time_fn(flash.flash_attention_fwd_reference, q, k, v, repeats=5, inner=3, **kw)
    plain_bwd = time_fn(flash.flash_attention_bwd_reference, q, k, v, out, lse, do,
                        repeats=5, inner=3, **kw)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (x.view(b, n, s, h).detach().requires_grad_() for x in (q, k, v))
    lib_fwd = time_fn(sdpa, qs, ks, vs, is_causal=True)
    lib_out = sdpa(qs, ks, vs, is_causal=True)
    lib_bwd = time_fn(torch.autograd.grad, lib_out, (qs, ks, vs), do.view(b, n, s, h),
                      retain_graph=True)
    lib_fwd_bwd = time_fn(lambda: torch.autograd.grad(
        sdpa(qs, ks, vs, is_causal=True), (qs, ks, vs), do.view(b, n, s, h)))

    pairs = int(flash._keep_mask(s, s, 1, True, None, q.device).sum()) * b * n
    tensor, rowvec = q.numel() * q.element_size(), lse.numel() * 4
    work = {   # (bytes read once + written once, FLOPs)
        "fwd": (4 * tensor + rowvec, 4 * h * pairs),
        "bwd_dkv": (6 * tensor + 2 * rowvec, 8 * h * pairs),
        "bwd_dq": (5 * tensor + 2 * rowvec, 6 * h * pairs),
    }
    rows = {}
    for name, launch in kernels.items():
        bound_ms, by = bound(*work[name])
        rows[name] = dict(
            ms=time_fn(launch) * 1e3, bound_ms=bound_ms, bound_by=by,
            plain_ms=(plain_fwd if name == "fwd" else plain_bwd) * 1e3,
            library_ms=(lib_fwd if name == "fwd" else lib_bwd) * 1e3,
            bytes=work[name][0], ops=work[name][1],
        )
        log(f"[time] flash {name} (folded q {tuple(q.shape)}, causal, bf16): kernel "
            f"{rows[name]['ms'] * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us ({by}), "
            f"plain {rows[name]['plain_ms'] * 1e3:.2f} us, sdpa "
            f"{rows[name]['library_ms'] * 1e3:.2f} us")
    log(f"[time] sdpa {tuple(qs.shape)} bf16 causal: fwd {lib_fwd * 1e6:.2f} us, bwd "
        f"{lib_bwd * 1e6:.2f} us, fwd+bwd {lib_fwd_bwd * 1e6:.2f} us; the plain backward "
        f"computes dq, dk and dv together ({plain_bwd * 1e6:.2f} us) on {card}")
    return rows, dict(sdpa_fwd_ms=lib_fwd * 1e3, sdpa_bwd_ms=lib_bwd * 1e3,
                      sdpa_fwd_bwd_ms=lib_fwd_bwd * 1e3)


def time_shape(gen, name, *, s, index):
    """Kernel, plain version and SDPA at one main-path shape (bf16)."""
    dtype, n, h, length = torch.bfloat16, 12, 64, 1024
    q = randn(gen, B, s, n, h, dtype=dtype)
    kc = randn(gen, B, n, length, h, dtype=dtype)
    vc = randn(gen, B, n, length, h, dtype=dtype)
    idx = torch.full((), index, dtype=torch.int32, device="cuda")
    ms = time_fn(decode_attention, q, kc, vc, idx) * 1e3
    plain_ms = time_fn(decode_attention_reference, q, kc, vc, idx) * 1e3
    valid = index + s
    qt, kt, vt = q.transpose(1, 2).contiguous(), kc[:, :, :valid], vc[:, :, :valid]
    library_ms = time_fn(
        torch.nn.functional.scaled_dot_product_attention, qt, kt, vt, is_causal=s > 1,
    ) * 1e3
    itemsize = q.element_size()
    nbytes = 2 * q.numel() * itemsize + 2 * B * n * valid * h * itemsize
    pairs = s * index + s * (s + 1) // 2        # (query, key) pairs per (b, head)
    ops = 4 * h * pairs * B * n
    bound_ms, bound_by = bound(nbytes, ops)
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms, bytes=nbytes, ops=ops)
    log(f"[time] decode_attention {name} (q {tuple(q.shape)}, index {index}, bf16): "
        f"kernel {ms * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}), "
        f"plain {plain_ms * 1e3:.2f} us, sdpa {library_ms * 1e3:.2f} us")
    return row


def queued_time(fn, *args, inner=20, repeats=7, **kwargs):
    """Median device seconds per call of ``fn``, as kernels run back to back:
    each sample enqueues ``inner`` calls behind a sleeping kernel, so the
    CUDA events time the device work and not the host's launch overhead
    (which exceeds a decode-size kernel). Returns (seconds, samples whose
    enqueue outlasted the sleep, which may hold host gaps)."""
    for _ in range(3):
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    samples, late = [], 0
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)        # ~10 ms at the H100's clocks
        start.record()
        for _ in range(inner):
            fn(*args, **kwargs)
        late += bool(start.query())          # the sleep ended before the enqueue did
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 1e3 / inner)
    return statistics.median(samples), late


def time_fused_norm(gen, card):
    """The fused-norm kernels at the main path's shapes, LayerNorm with
    beta as the 125M model runs it, bf16 rows: the forward with and without
    the residual at the train rows (statistics written, fp32 gamma) and at
    the prefill and decode rows (no statistics, bf16 gamma, as generation
    runs it); the backward at the train rows without and with ``dr``. Each
    beside its plain version, its bound (bytes at the card's memory rate;
    each input read once, each output written once) and the library
    yardstick: ``F.layer_norm`` of ``x + resid`` (the add included), and its
    autograd backward, with gamma and beta cast to bf16 beforehand
    (``F.layer_norm`` takes one dtype)."""
    bf16, m = torch.bfloat16, 768
    ln = torch.nn.functional.layer_norm
    fp32_rate = 67e12                 # fp32 outside the tensor cores (H100 SXM)
    rows_out = {}

    def record(key, launch, plain, library, nbytes, ops):
        ms, late = queued_time(launch)
        plain_ms, plain_late = queued_time(plain, inner=3, repeats=5)
        lib_ms, lib_late = queued_time(library)
        bound_ms, by = bound(nbytes, ops, fp32_rate)
        row = dict(ms=ms * 1e3, plain_ms=plain_ms * 1e3, library_ms=lib_ms * 1e3,
                   bound_ms=bound_ms, bound_by=by, bytes=nbytes, ops=ops,
                   late_samples=late + plain_late + lib_late)
        rows_out[key] = row
        log(f"[time] fused_norm {key} bf16: kernel {row['ms'] * 1e3:.2f} us, bound "
            f"{bound_ms * 1e3:.2f} us ({by}), plain {row['plain_ms'] * 1e3:.2f} us, "
            f"F.layer_norm {row['library_ms'] * 1e3:.2f} us"
            + (f" ({row['late_samples']} samples enqueued past the sleep)"
               if row["late_samples"] else ""))

    for rows_name in ("train", "prefill", "decode"):
        rows = NORM_ROWS[rows_name]
        stats = rows_name == "train"
        param_dtype = torch.float32 if stats else bf16
        pbytes = 2 * m * (4 if stats else 2)
        for resid in (True, False):
            t = norm_inputs(gen, rows, bf16, param_dtype, resid, True)
            x, res, g, b = t["x"], t["res"], t["g"], t["b"]
            g16, b16 = g.to(bf16), b.to(bf16)
            kw = dict(eps=1e-6, kind="layernorm", needs_stats=stats)
            tensors = (4 if resid else 2) * rows * m * 2
            record(f"fwd{' +resid' if resid else ''} {rows}x768{' stats' if stats else ''}",
                   lambda: norm_ops._launch_fwd(x, res, g, b, **kw),
                   lambda: norm_ops.fused_residual_norm_reference(x, res, g, b, **kw),
                   (lambda: ln(x + res, (m,), g16, b16)) if resid else
                   (lambda: ln(x, (m,), g16, b16)),
                   tensors + pbytes + (8 * rows if stats else 0), 10 * rows * m)
    rows = NORM_ROWS["train"]
    t = norm_inputs(gen, rows, bf16, torch.float32, True, True)
    y, r, mean, rstd = norm_ops.fused_residual_norm_reference(
        t["x"], t["res"], t["g"], t["b"], eps=1e-6, kind="layernorm", needs_stats=True)
    s = r.detach().clone().requires_grad_()
    g, b = (p.detach().to(bf16).requires_grad_() for p in (t["g"], t["b"]))
    lib_out = ln(s, (m,), g, b)
    for dr in (None, t["dr"]):
        args = (t["dy"], r, t["g"], mean, rstd, dr)
        kw = dict(kind="layernorm", has_beta=True)
        tensors = (3 if dr is None else 4) * rows * m * 2
        record(f"bwd{' +dr' if dr is not None else ''} {rows}x768",
               lambda: norm_ops._launch_bwd(*args, **kw),
               lambda: norm_ops.fused_residual_norm_bwd_reference(*args, **kw),
               lambda: torch.autograd.grad(lib_out, (s, g, b), t["dy"], retain_graph=True),
               tensors + 8 * rows + 3 * m * 4, 14 * rows * m)
    log(f"[time] fused_norm kernels measured on {card}")
    return rows_out


def time_decode_int8(gen, card):
    """Decode attention at the 125M decode shape (b=8, 12 heads, index 200,
    q bf16), int8 against bf16 caches, queued (device time): kernel, plain
    version, bound (the valid prefix's bytes: int8 one byte a value plus 4
    bytes of scale per token and head) and SDPA on the bf16 prefix as the
    yardstick (no library call reads an int8 cache with scales)."""
    n, h, length, index = 12, 64, 1024, 200
    valid = index + 1
    q = randn(gen, B, 1, n, h, dtype=torch.bfloat16)
    idx = torch.full((), index, dtype=torch.int32, device="cuda")
    kc, ks = int8_kv(gen, B, n, length, h)
    vc, vs = int8_kv(gen, B, n, length, h)
    kf, vf = (randn(gen, B, n, length, h, dtype=torch.bfloat16) for _ in range(2))
    sdpa_args = (q.transpose(1, 2).contiguous(), kf[:, :, :valid], vf[:, :, :valid])
    lib_ms, _ = queued_time(torch.nn.functional.scaled_dot_product_attention, *sdpa_args)
    qbytes = 2 * q.numel() * 2
    ops = 4 * h * valid * B * n
    rows = {}
    for name, args, kw, per_slot in (
        ("int8", (q, kc, vc, idx), dict(k_scale=ks, v_scale=vs), h + 4),
        ("bf16", (q, kf, vf, idx), {}, 2 * h),
    ):
        ms, late = queued_time(decode_attention, *args, **kw)
        plain_ms, _ = queued_time(decode_attention_reference, *args, inner=3, repeats=5, **kw)
        nbytes = qbytes + 2 * B * n * valid * per_slot
        bound_ms, by = bound(nbytes, ops)
        rows[name] = dict(ms=ms * 1e3, plain_ms=plain_ms * 1e3, bound_ms=bound_ms, bound_by=by,
                          library_ms=lib_ms * 1e3, bytes=nbytes, ops=ops, late_samples=late)
        log(f"[time] decode_attention decode {name} cache (q {tuple(q.shape)}, index {index}, "
            f"queued): kernel {ms * 1e6:.2f} us, bound {bound_ms * 1e3:.2f} us ({by}, "
            f"{nbytes / 1e6:.2f} MB), plain {plain_ms * 1e6:.2f} us, sdpa bf16 "
            f"{lib_ms * 1e6:.2f} us on {card}")
    return rows


def int4_weight(gen, k, n, group):
    """A seeded (K, N) kernel of the 125M init's scale, int4-quantized."""
    w = torch.randn(k, n, generator=gen, device="cuda") * 0.02
    return quantize_leaf_int4(w, group)


def rel_err(name, got, want):
    """Max abs error of ``got`` against ``want``, the same relative to the
    largest reference magnitude, and the share of elements that differ."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    abs_err = (got.float() - want.float()).abs().max().item()
    flips = (got != want).float().mean().item()
    return abs_err / want.float().abs().max().item(), abs_err, flips


def check_int4(gen):
    """The four int4 kernels against their plain versions in fp32 and bf16
    activations: the 125M decode (M=8) and prefill (M=1024) shapes of every
    site, an odd M (37), a whole-K group and group 64 → per kernel and dtype
    the largest relative (checked) and absolute error."""
    mat_cases = [(f"{site} {ph}", m, *INT4_SITES[site], 128)
                 for site in ("qkv_out", "lm_head") for ph, m in (("decode", B), ("prefill", 1024))]
    extra = [("m37", 37, 768, 768, 128), ("whole-K group", B, 768, 768, 768),
             ("group 64", B, 768, 768, 64)]
    w4a8_cases = [(f"{site} {ph}", m, k, n, 128) for site, (k, n) in INT4_SITES.items()
                  for ph, m in (("decode", B), ("prefill", 1024))] + extra
    triple_cases = [(f"qkv {ph}", m, 768, 768, 128) for ph, m in (("decode", B), ("prefill", 1024))]
    ff_cases = [("ff decode", B, 128), ("ff prefill", 1024, 128), ("ff m37", 37, 128),
                ("ff whole-K/H group", B, 4096), ("ff group 64", B, 64)]
    worst = {}

    def note(kernel, dtype, name, errs, tol):
        log(f"[int4] {kernel} {name} {str(dtype)[6:]}: max err {errs[0]:.3e} of the largest "
            f"|ref| (abs {errs[1]:.3e}, tol {tol:.3g}), {errs[2]:.2e} of outputs differ")
        if not errs[0] <= tol:
            raise AssertionError(f"{kernel} {name} {dtype}: relative error {errs[0]} > {tol}")
        if dtype == torch.bfloat16 and not errs[2] <= INT4_BF16_FLIPS:
            raise AssertionError(f"{kernel} {name}: {errs[2]} of bf16 outputs differ from the "
                                 f"plain version's > {INT4_BF16_FLIPS}")
        old = worst.get((kernel, dtype), (0.0, 0.0))
        worst[kernel, dtype] = (max(old[0], errs[0]), max(old[1], errs[1]))

    for dtype in (torch.float32, torch.bfloat16):
        tol = INT4_TOL[dtype]
        for name, m, k, n, g in mat_cases + extra:
            node = int4_weight(gen, k, n, g)
            x = randn(gen, m, k, dtype=dtype)
            got = mm4.int4_matmul(x, node["q4"], node["scale"], group=min(g, k))
            want = mm4.int4_matmul_reference(x, node["q4"], node["scale"], group=min(g, k))
            note("int4_matmul", dtype, name, rel_err(name, got, want), tol)
        for name, m, k, n, g in triple_cases + extra:
            nodes = [int4_weight(gen, k, n, g) for _ in range(3)]
            x = randn(gen, m, k, dtype=dtype)
            pairs = [(nd["q4"], nd["scale"]) for nd in nodes]
            outs = mm4.int4_matmul3(x, pairs, group=min(g, k))
            errs = [rel_err(name, o, mm4.int4_matmul_reference(x, *pair, group=min(g, k)))
                    for o, pair in zip(outs, pairs)]
            note("int4_matmul3", dtype, name, tuple(map(max, zip(*errs))), tol)
        for name, m, k, n, g in w4a8_cases:
            node = int4_weight(gen, k, n, g)
            x = randn(gen, m, k, dtype=dtype)
            got = mm4.int4_matmul(x, node["q4"], node["scale"], group=min(g, k), w4a8=True)
            xq, sx = mm4.quantize_rows_int8(x)
            want = mm4.int4_matmul_w4a8_reference(xq, sx, node["q4"], node["scale"],
                                                  group=min(g, k), out_dtype=dtype)
            note("int4_matmul_w4a8", dtype, name, rel_err(name, got, want),
                 W4A8_TOL if dtype == torch.float32 else tol)
        for name, m, g in ff_cases:
            up, dn = int4_weight(gen, 768, 3072, g), int4_weight(gen, 3072, 768, g)
            x = randn(gen, m, 768, dtype=dtype)
            args = (up["q4"], up["scale"], dn["q4"], dn["scale"])
            got = ff4.int4_ff(x, *args, group=g)
            want = ff4.int4_ff_reference(x, *args, group=g)
            note("int4_ff", dtype, name, rel_err(name, got, want), tol)
    torch.cuda.synchronize()
    return worst


INT4_KERNELS = ("int4_matmul", "int4_matmul_w4a8", "int4_matmul3", "int4_ff")


def reset_launches() -> None:
    decode_attention.launches = 0
    mm4.int4_matmul.launches = dict.fromkeys(mm4.int4_matmul.launches, 0)
    mm4.int4_matmul3.launches = 0
    ff4.int4_ff.launches = 0


def read_launches() -> dict:
    return {"int4_matmul": mm4.int4_matmul.launches["w4a16"],
            "int4_matmul_w4a8": mm4.int4_matmul.launches["w4a8"],
            "int4_matmul3": mm4.int4_matmul3.launches, "int4_ff": ff4.int4_ff.launches,
            "decode_attention": decode_attention.launches}


def run_quantized_path(params, gen):
    """int4 serving of the 125M model through ``make_generate_fn``: the
    ``"fused"`` and ``"fused_w4a8"`` runs, each with its launches counted
    from zero around one rectangular generate and its tokens held to the
    dense bf16 model on the dequantized weights (teacher-forced)."""
    cfg = CONFIG_125M
    q4 = quantize_tree(params, bits=4)
    tf_model = Transformer(dataclasses.replace(cfg, param_dtype=torch.bfloat16),
                           device="cuda", seed=1).eval()
    tf_model.load_state_dict(dequantize_tree(q4, torch.bfloat16))
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda",
                           dtype=torch.int32)
    layers = cfg.num_layers
    want = {
        "fused": {"int4_matmul": (layers + 1) * NEW, "int4_matmul_w4a8": 0,
                  "int4_matmul3": layers * NEW, "int4_ff": layers * NEW,
                  "decode_attention": layers * NEW},
        "fused_w4a8": {"int4_matmul": 0, "int4_matmul_w4a8": (6 * layers + 1) * NEW,
                       "int4_matmul3": 0, "int4_ff": 0, "decode_attention": layers * NEW},
    }
    rows, fns = {}, {}
    for mode in ("fused", "fused_w4a8"):
        fn = fns[mode] = make_generate_fn(cfg, max_new_tokens=NEW,
                                          inference_dtype=torch.bfloat16, dequantize=mode)
        torch.cuda.synchronize()
        reset_launches()
        out = fn(q4, prompt)
        torch.cuda.synchronize()
        launches = read_launches()
        log(f"[main] 125M int4 generate dequantize={mode!r} b={B} prompt {PROMPT} +{NEW}: "
            f"launches {launches}")
        if launches != want[mode]:
            raise AssertionError(f"dequantize={mode!r} launched {launches}, want {want[mode]}")
        check_output(out, B, PROMPT + NEW, cfg.vocab_size)
        gap = teacher_forced_gap(tf_model, out, [PROMPT] * B, [PROMPT + NEW] * B)
        log(f"[main] int4 {mode} teacher-forced max gap {gap:.4f} against the dense bf16 "
            f"model on the dequantized weights (limit {QUANT_TF_GAP[mode]})")
        if gap > QUANT_TF_GAP[mode]:
            raise AssertionError(f"int4 {mode} teacher-forced gap {gap} > {QUANT_TF_GAP[mode]}")
        rows[mode] = dict(launches=launches, teacher_forced_max_gap=gap)
    del tf_model
    return q4, prompt, rows, fns


def run_ladder(params, q4, prompt, card, int4_fns):
    """``bench.py``'s ``_decode_ladder`` at the 125M serving shape: bf16,
    int8 (``dequantize=True``), int4-fused and int4-w4a8 (the generate
    functions of the quantized runs), timed interleaved (every round times
    each variant once; medians over the rounds; the process is warm from
    the phases before, and no call compiles anything): tok/s, ms per token
    step, served MB and MBU (served weights plus the mean valid KV cache
    per token step over the card's memory rate)."""
    cfg = CONFIG_125M

    def to_bf16(t):
        return t.to(torch.bfloat16) if t.is_floating_point() else t

    variants = [("bf16", {k: to_bf16(v) for k, v in params.items()}, False),
                ("int8", quantize_tree(params), True),
                ("int4-fused", q4, "fused"), ("int4-w4a8", q4, "fused_w4a8")]
    fns = {"int4-fused": int4_fns["fused"], "int4-w4a8": int4_fns["fused_w4a8"]}
    for name, _, mode in variants[:2]:
        fns[name] = make_generate_fn(cfg, max_new_tokens=NEW, inference_dtype=torch.bfloat16,
                                     dequantize=mode)
    times = interleaved_seconds(
        {name: functools.partial(fns[name], tree, prompt) for name, tree, _ in variants},
        LADDER_ROUNDS)
    n_kv = cfg.num_kv_heads or cfg.num_heads
    cache_bytes = cfg.num_layers * B * n_kv * (PROMPT + NEW / 2) * cfg.head_dim * 2 * 2
    rows = {}
    for name, tree, _ in variants:
        served = quantized_bytes(map_unquantized(to_bf16, tree))
        secs = statistics.median(times[name])
        rows[name] = dict(tok_s=B * NEW / secs, ms_per_token_step=secs / NEW * 1e3,
                          served_mb=served / 1e6, mbu=mbu(served + cache_bytes, secs / NEW),
                          seconds=times[name])
        log(f"[ladder] 125M decode, {name} (b={B}, prompt {PROMPT}, +{NEW} new): "
            f"{rows[name]['tok_s']:,.1f} tok/s, {rows[name]['ms_per_token_step']:.3f} "
            f"ms/token-step, served {served / 1e6:,.1f} MB, MBU={rows[name]['mbu'] or 0:.4%} "
            f"(calls {[round(t, 4) for t in times[name]]} s) on {card}")
    order = sorted(rows, key=lambda n: rows[n]["ms_per_token_step"])
    log(f"[ladder] 125M decode ladder ordering (interleaved medians of {LADDER_ROUNDS}, "
        f"fastest first): {' > '.join(order)}")
    return rows, fns["int4-fused"]


def time_int4(gen, card):
    """Each int4 kernel at its 125M sites (decode M=8; the prefill M=1024
    of the lm_head, q/k/v and FF as well), bf16: the kernel, its plain
    version, the library yardstick (``torch.matmul`` of x with the weight
    dequantized to bf16 beforehand; the FF: two of them and a GELU) and the
    bound (w4a8's operations at the int8 peak, 1979 TOP/s)."""
    bf16 = torch.bfloat16
    rows = {}

    def record(kernel, site, m, launch, plain, library, nbytes, ops, peak):
        ms, late = queued_time(launch)
        plain_ms, plain_late = queued_time(plain, inner=3, repeats=5)
        lib_ms, lib_late = queued_time(library)
        bound_ms, by = bound(nbytes, ops, peak)
        row = dict(ms=ms * 1e3, plain_ms=plain_ms * 1e3, yardstick_ms=lib_ms * 1e3,
                   bound_ms=bound_ms, bound_by=by, bytes=nbytes, ops=ops,
                   late_samples=late + plain_late + lib_late)
        rows.setdefault(kernel, {})[f"{site} m={m}"] = row
        log(f"[time] {kernel} {site} m={m} bf16: kernel {row['ms'] * 1e3:.2f} us, bound "
            f"{bound_ms * 1e3:.2f} us ({by}), plain {row['plain_ms'] * 1e3:.2f} us, bf16 "
            f"dense yardstick {row['yardstick_ms'] * 1e3:.2f} us"
            + (f" ({row['late_samples']} samples enqueued past the sleep)" if row["late_samples"] else ""))

    int8_peak = 1979e12
    for site, (k, n) in INT4_SITES.items():
        node = int4_weight(gen, k, n, 128)
        q4, s = node["q4"], node["scale"]
        w = dequantize_leaf_int4(node, bf16)
        wbytes = q4.numel() + s.numel() * 4
        for m in (B, 1024) if site == "lm_head" else (B,):
            x = randn(gen, m, k, dtype=bf16)
            xq, sx = mm4.quantize_rows_int8(x)
            if site in ("qkv_out", "lm_head"):
                record("int4_matmul", site, m,
                       lambda: mm4._launch_w4a16(x, [(q4, s)], group=128),
                       lambda: mm4.int4_matmul_reference(x, q4, s, group=128),
                       lambda: torch.matmul(x, w),
                       2 * m * k + wbytes + 2 * m * n, 2 * m * k * n, None)
            record("int4_matmul_w4a8", site, m,
                   lambda: mm4._launch_w4a8(xq, sx, q4, s, group=128, out_dtype=bf16),
                   lambda: mm4.int4_matmul_w4a8_reference(xq, sx, q4, s, group=128,
                                                          out_dtype=bf16),
                   lambda: torch.matmul(x, w),
                   m * k + 4 * m + wbytes + 2 * m * n, 2 * m * k * n, int8_peak)
    nodes = [int4_weight(gen, 768, 768, 128) for _ in range(3)]
    pairs = [(nd["q4"], nd["scale"]) for nd in nodes]
    w_qkv = torch.cat([dequantize_leaf_int4(nd, bf16) for nd in nodes], dim=1)
    wbytes = sum(q.numel() + sc.numel() * 4 for q, sc in pairs)
    for m in (B, 1024):
        x = randn(gen, m, 768, dtype=bf16)
        record("int4_matmul3", "qkv", m, lambda: mm4._launch_w4a16(x, pairs, group=128),
               lambda: [mm4.int4_matmul_reference(x, *p, group=128) for p in pairs],
               lambda: torch.matmul(x, w_qkv),
               2 * m * 768 + wbytes + 3 * 2 * m * 768, 3 * 2 * m * 768 * 768, None)
    up, dn = int4_weight(gen, 768, 3072, 128), int4_weight(gen, 3072, 768, 128)
    args = (up["q4"], up["scale"], dn["q4"], dn["scale"])
    w1, w2 = dequantize_leaf_int4(up, bf16), dequantize_leaf_int4(dn, bf16)
    wbytes = sum(t.numel() * t.element_size() for t in args)
    gelu = torch.nn.functional.gelu
    for m in (B, 1024):
        x = randn(gen, m, 768, dtype=bf16)
        record("int4_ff", "ff", m, lambda: ff4._launch_cuda(x, *args, group=128),
               lambda: ff4.int4_ff_reference(x, *args, group=128),
               lambda: torch.matmul(gelu(torch.matmul(x, w1), approximate="tanh"), w2),
               2 * m * 768 + wbytes + 2 * m * 768, 2 * 2 * m * 768 * 3072, None)
    log(f"[time] int4 kernels measured on {card}")
    return rows


def build_kernels() -> None:
    """Build every kernel source at once, one ``nvcc`` each."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(name):
        t0 = time.perf_counter()
        lib = _build.build(name)
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        built = list(pool.map(timed, ("decode_attention", "flash_attention", "int4_matmul",
                                      "int4_ff", "fused_norm")))
    for lib, secs in built:
        log(f"[build] {lib.name} in {secs:.1f} s")
    log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")
    for name, report in _build.reports.items():
        for kernel, regs, spills in ptxas_usage(report):
            log(f"[build] {name}: {kernel}: {regs} registers, {spills}")


_MANGLED_TYPES = {"f": "fp32", "a": "int8", "__nv_bfloat16": "bf16"}


def template_args(mangled: str) -> list[str]:
    """The template arguments of an Itanium-mangled instantiation, from just
    after its ``I`` to the matching ``E``: types, int and bool literals."""
    args, i = [], 0
    while i < len(mangled) and mangled[i] != "E":
        lit = re.match(r"L([ib])(\d+)E", mangled[i:])
        named = re.match(r"(\d+)", mangled[i:])
        again = re.match(r"S\d*_", mangled[i:])
        if again:       # a substitution: here always the type argument before
            args.append(args[-1])
            i += again.end()
        elif lit:
            args.append(lit.group(2) if lit.group(1) == "i" else
                        ("true" if lit.group(2) == "1" else "false"))
            i += lit.end()
        elif named:
            n = int(named.group(1))
            name = mangled[i + named.end(): i + named.end() + n]
            args.append(_MANGLED_TYPES.get(name, name))
            i += named.end() + n
        else:
            args.append(_MANGLED_TYPES.get(mangled[i], mangled[i]))
            i += 1
    return args


def ptxas_usage(report: str):
    """(kernel, registers, spill line) for each kernel in nvcc's
    ``-Xptxas=-v`` report, the kernel named by its template arguments."""
    kernel = spills = None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '\S*?\d((?:flash_[a-z_]+?|decode_attention"
                          r"|int4_matmul(?:_w4a8)?|int4_ff(?:_reduce)?"
                          r"|fused_norm_(?:fwd|bwd|reduce))_kernel)I(\w+)", line)
        if entry:
            kernel = f"{entry.group(1)}<{', '.join(template_args(entry.group(2)))}>"
        elif "spill" in line:
            spills = line.strip()
        elif kernel and (used := re.search(r"Used (\d+) registers", line)):
            yield kernel, int(used.group(1)), spills
            kernel = spills = None


def result_line(kind: str) -> dict:
    """The last line: every phase ran on the one card this run used, so
    the count is 1 whatever else the host shows."""
    return {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[preflight] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = check_kernel(gen)
    int8_errs = check_kernel(gen, int8=True)
    flash_errs = check_flash(gen)
    int4_errs = check_int4(gen)
    norm_errs = check_fused_norm(gen)

    model = Transformer(CONFIG_125M, device="cuda", seed=0)
    params = model.state_dict()
    tf_cfg = dataclasses.replace(CONFIG_125M, param_dtype=torch.bfloat16)
    tf_model = Transformer(tf_cfg, device="cuda", seed=1).eval()
    tf_model.load_state_dict(params)
    del model
    main_path = run_main_path(params, gen, tf_model, card)
    prefill = time_shape(gen, "prefill", s=PROMPT, index=0)
    decode = time_shape(gen, "decode", s=1, index=200)
    breakdown = profile_generate(params, gen, main_path["ms_per_step"])
    fused_gen = run_fused_generate(params, gen, tf_model, card)
    del tf_model
    torch.cuda.empty_cache()
    int8_gen = run_int8_generate(params, gen, card)
    decode_int8 = time_decode_int8(gen, card)
    torch.cuda.empty_cache()

    q4, q_prompt, quant, int4_fns = run_quantized_path(params, gen)
    ladder, fused_fn = run_ladder(params, q4, q_prompt, card, int4_fns)
    del int4_fns
    quant_breakdown = profile_summary(
        "125M int4-fused generate token step", lambda: fused_fn(q4, q_prompt), NEW,
        ladder["int4-fused"]["ms_per_token_step"])
    del params, q4, fused_fn
    torch.cuda.empty_cache()
    int4_times = time_int4(gen, card)
    torch.cuda.empty_cache()

    step = step_check(train_batch(gen, CONFIG_125M.vocab_size))
    torch.cuda.empty_cache()
    train = run_train_path(gen, card)
    torch.cuda.empty_cache()
    fused_train = run_fused_train_path(gen, card)
    torch.cuda.empty_cache()
    flash_times, sdpa_times = time_flash(gen, card)
    norm_times = time_fused_norm(gen, card)
    log(f"[time] measured on {card}")

    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entries = [dict(
        name="decode_attention", route="cuda", source=KERNEL_SOURCE, replaces=REPLACES,
        launches=main_path["rect_launches"], ragged_launches=main_path["ragged_launches"],
        max_abs_err=errs[torch.bfloat16],
        max_err_bf16=errs[torch.bfloat16], max_err_fp32=errs[torch.float32],
        **{k: decode[k] for k in timing_keys},
        shapes={"prefill": prefill, "decode": decode},
        # The int8 cache mode: its checks, its launches in the int8-cache
        # generate, and its queued time beside the bf16 cache's at decode.
        int8=dict(max_abs_err=int8_errs[torch.bfloat16], max_err_bf16=int8_errs[torch.bfloat16],
                  max_err_fp32=int8_errs[torch.float32], launches=int8_gen["launches"],
                  **{k: decode_int8["int8"][k] for k in timing_keys},
                  bf16_cache_queued=decode_int8["bf16"]),
    )]
    for name in ("fwd", "bwd_dkv", "bwd_dq"):
        entries.append(dict(
            name=f"flash_{name}", route="cuda", source=FLASH_SOURCE,
            replaces=FLASH_REPLACES[name], launches=train["launches"][name],
            max_abs_err=flash_errs[torch.bfloat16, "abs"][name],
            max_err_bf16=flash_errs[torch.bfloat16, "checked"][name],
            max_err_fp32=flash_errs[torch.float32, "checked"][name],
            **{k: flash_times[name][k] for k in timing_keys},
            bytes=flash_times[name]["bytes"], ops=flash_times[name]["ops"],
        ))
    # The int4 kernels: top-level numbers at the 768 x 768 decode site (q, k,
    # v, out: most of the launches), every timed site under "shapes".
    main_site = {"int4_matmul": "qkv_out m=8", "int4_matmul_w4a8": "qkv_out m=8",
                 "int4_matmul3": "qkv m=8", "int4_ff": "ff m=8"}
    main_run = {"int4_matmul": "fused", "int4_matmul_w4a8": "fused_w4a8",
                "int4_matmul3": "fused", "int4_ff": "fused"}
    for name in INT4_KERNELS:
        row = int4_times[name][main_site[name]]
        entries.append(dict(
            name=name, route="cuda", source=INT4_FF_SOURCE if name == "int4_ff" else INT4_SOURCE,
            replaces=INT4_REPLACES[name], launches=quant[main_run[name]]["launches"][name],
            max_abs_err=int4_errs[name, torch.bfloat16][1],
            max_err_bf16=int4_errs[name, torch.bfloat16][0],
            max_err_fp32=int4_errs[name, torch.float32][0],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"],
            # No PyTorch call computes a product on packed int4. The yardstick
            # is torch.matmul on the weights dequantized to bf16 beforehand;
            # the FF's takes two and a GELU, so it is no single call and
            # stays under "shapes".
            library_ms=None if name == "int4_ff" else row["yardstick_ms"],
            library_call=None if name == "int4_ff" else
            "torch.matmul(x, W dequantized to bf16 beforehand)",
            shapes=int4_times[name],
        ))
    # The fused-norm kernels: launches of the fused-norm train call (and the
    # no-statistics forwards of the fused-norm generate), errors over every
    # checked shape, top-level times at the train rows (forward with the
    # residual; backward without dr), every timed shape under "shapes".
    train_rows = NORM_ROWS["train"]
    for name, key in (("fwd", f"fwd +resid {train_rows}x768 stats"),
                      ("bwd", f"bwd {train_rows}x768")):
        row = norm_times[key]
        entries.append(dict(
            name=f"fused_norm_{name}", route="cuda", source=NORM_SOURCE,
            replaces=NORM_REPLACES[name], launches=fused_train["launches"][name],
            generate_launches=fused_gen["launches"]["fwd_nostats" if name == "fwd" else name],
            max_abs_err=norm_errs[name, torch.bfloat16][1],
            max_err_bf16=norm_errs[name, torch.bfloat16][0],
            max_err_fp32=norm_errs[name, torch.float32][0],
            bf16_differing_share=norm_errs[name, torch.bfloat16][2],
            **{k: row[k] for k in timing_keys},
            library_call="torch.nn.functional.layer_norm(x + resid)" if name == "fwd" else
            "autograd backward of torch.nn.functional.layer_norm",
            shapes={k: v for k, v in norm_times.items() if k.startswith(name)},
        ))
    generate = dict(tok_s=main_path["tok_s"], ms_per_token_step=main_path["ms_per_step"],
                    teacher_forced_max_gap=main_path["gap"], step_breakdown=breakdown)
    quantized = dict(runs=quant, ladder=ladder, int4_fused_step_breakdown=quant_breakdown)
    print(json.dumps({"kernels": entries, "generate": generate, "quantized": quantized,
                      "train": train, "train_step_check": step, "sdpa": sdpa_times,
                      "fused_norm_train": fused_train, "fused_norm_generate": fused_gen,
                      "int8_cache_generate": int8_gen}))
    print(card)
    print(json.dumps(result_line(torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
