#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``learning_jax_sharding_tpu_torch/csrc``
(into ``build/torch_kernels/``, one ``nvcc`` per source, in parallel) and
holds each against its plain PyTorch version on the card (decode attention
with float and int8 caches, and over page pools through a block table, where
it must also give the contiguous kernel's bits; flash attention, its
backward in both designs (tensor cores, which bf16 takes, and CUDA cores,
which fp32 takes); the int4
kernels in every design (small-M tensor cores for decode rows, unsplit and
split over K; tensor cores for prefill rows; CUDA cores; the whole-FF
kernel's small-M and tensor-core designs, the latter at every split of its
down launch), the fused residual+norm forward and backward). Then drives the
port's main paths at
the 125M model's full width and depth (seeded random weights): KV-cached
greedy generation in bf16 through ``make_generate_fn``, checked against a
teacher-forced dense forward, with the plain norm, with ``fused_norm=True``
and with ``kv_cache_dtype=torch.int8`` (held to the dense backend over the
same int8 cache); int4 quantized serving of the same model through
``make_generate_fn(dequantize="fused" | "fused_w4a8")`` over
``quantize_tree(bits=4)``, checked against the dense bf16 model on the
dequantized weights, its prefill's int4 matmuls and FFs held to the
tensor-core designs and its decode steps' to the small-M ones, then the
decode ladder (bf16, int8, int4-fused, int4-w4a8), the int4 prefill alone
and the int4 generates against the same calls with their decode matmuls,
or their FFs, on the CUDA cores; the
continuous engine (``models/serving.py``) on
``bench.py::bench_serving_125m``'s workload, unpaged, paged, with the prefix
cache cold and warm, and int4-fused + paged + prefix, every paged variant's
tokens held equal to the unpaged engine's and teacher-forced against the
dense forward; and the train step (flash attention, fused loss, AdamW, b=8,
s=1024, 8 steps per call) through ``make_train_step``, checked for descent
and against the dense attention path, its flash backward held to the
tensor-core design, and again with ``fused_norm=True`` against the
plain-norm step, both timed against the same steps with the flash backward
forced onto the CUDA-core design. Then the probe kernels (``csrc/probes.cu``:
a one-block copy, a one-call matmul at decode rows, the flash block's
ablation) against their plain versions at the probe scripts' shapes, and
the port's probe scripts through their own functions: the launch floor
(``scripts/perf_call_floor.py``), the launch audit at a 1.4B decode shape
(``scripts/perf_launch_audit.py``: bf16, int8 dequant and int4 fused, each
generate's launches held to its designs) and the flash ceiling at long
context (``scripts/perf_flash_ceiling.py``: the flash kernels at S=8192,
composed train steps at S=8192 and 16384, causal and windowed, every flash
launch on the tensor cores, and the ablation); then the design rules timed
at the 1.4B shape. Each path's kernel launches are counted from zero around
one run. Times the paths and the kernels, profiles the paths,
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

import numpy as np
import torch

from learning_jax_sharding_tpu_torch.models.attention import quantize_kv_chunk
from learning_jax_sharding_tpu_torch.models.decoding import (
    apply_dequantize_policy,
    derive_decode_config,
    make_cached_apply,
    make_param_caster,
)
from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn
from learning_jax_sharding_tpu_torch.models.quantize import (
    dequantize_leaf_int4,
    dequantize_tree,
    map_unquantized,
    quantize_leaf_int4,
    quantize_tree,
    quantized_bytes,
)
from learning_jax_sharding_tpu_torch.models.serving import make_continuous_engine
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_125M,
    Transformer,
    fused_next_token_loss,
)
from learning_jax_sharding_tpu_torch.scripts import (
    perf_call_floor,
    perf_flash_ceiling,
    perf_launch_audit,
)
from learning_jax_sharding_tpu_torch.ops import _build
from learning_jax_sharding_tpu_torch.ops import decode_attention as da
from learning_jax_sharding_tpu_torch.ops import flash_attention as flash
from learning_jax_sharding_tpu_torch.ops import fused_norm as norm_ops
from learning_jax_sharding_tpu_torch.ops import int4_ff as ff4
from learning_jax_sharding_tpu_torch.ops import int4_matmul as mm4
from learning_jax_sharding_tpu_torch.ops import probes
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
    bound,
    device_peak_flops,
    device_profile,
    mbu,
    mfu,
    queued_time,
    time_fn,
)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CHECK_SPLITS = 3   # the split every decode-attention check runs beside one piece
SPLIT_SWEEP = (1, 2, 3, 4, 6, 8, 12, 16)   # splits timed at each decode-attention shape
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
PAGED_CHUNK = 64   # the engine's refill chunk
# The engine phase: bench.py::bench_serving_125m's workload (24 requests, a
# shared 512-token system prompt + 32 own tokens, 8 slots, +32 new, refill
# chunk 64, decode blocks of 32 chained 9 deep, 93 pages of 64 tokens).
ENGINE_REQUESTS, ENGINE_SYSTEM, ENGINE_OWN, ENGINE_NEW = 24, 512, 32, 32
ENGINE_PAGE, ENGINE_PAGES = 64, 8 * 10 + 1 + 12
ENGINE_COMMON = dict(batch_size=B, max_new_tokens=ENGINE_NEW, refill_chunk=PAGED_CHUNK,
                     inference_dtype=torch.bfloat16, decode_block_steps=ENGINE_NEW,
                     decode_chain=9)
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
    # The tensor-core tiles' edges: a partial last tile of keys and of the 8000
    # folded rows, GQA group 8, a window shorter than a tile (rows see part of
    # one or two key tiles).
    "gqa8_window48_s1000": dict(b=1, s=1000, n=16, n_kv=2, h=64, causal=True, window=48),
    # H = 128 causal at the train step's length: the tensor-core design's H =
    # 128 instantiations (every operand read from shared memory; dQ's 64-key
    # tiles).
    "h128_causal_s1024": dict(b=2, s=1024, n=8, n_kv=8, h=128, causal=True),
}
# The designs each dtype holds the three kernels in: the public path (bf16 on
# the tensor cores, fp32 on the CUDA cores) and, in bf16, the CUDA-core design
# on the same inputs.
FLASH_DESIGNS = {torch.float32: ("cuda_core",), torch.bfloat16: ("tensor_core", "cuda_core")}
# The flash counters of a bf16 train call: every key moves by the same count.
FLASH_LAUNCH_KEYS = ("fwd", "bwd_dkv", "bwd_dq", "fwd_tensor_core", "bwd_dkv_tensor_core",
                     "bwd_dq_tensor_core")
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
# The checks of w4a16, the triple and w4a8: every site and one whose N is no
# multiple of the tensor-core tile's 128 columns nor of 16 (4-byte copies),
# at decode (8), small, odd and prefill row counts (generate's prefill 1024,
# the engine's refill chunk 512), with groups of 64 and 128 packed rows and
# one whole-K group (None).
INT4_CHECK_SITES = {**INT4_SITES, "partial_n": (768, 772)}
INT4_CHECK_ROWS = (B, 9, 16, 37, 512, 1000, 1024)
INT4_CHECK_GROUPS = (64, 128, None)
# The timed row counts: decode; 16, 32 and 64 rows, where the two designs
# cross over (a decode batch of that many slots); the engine's refill chunk;
# generate's prefill.
INT4_TIME_ROWS = (B, 16, 32, 64, B * PAGED_CHUNK, B * PROMPT)
# HBM-cold timing (decode rows): calls rotate through copies of the weights
# that together hold this many bytes, past the H100's 50 MB L2.
COLD_BYTES = 120_000_000
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
PROBES_SOURCE = "learning_jax_sharding_tpu_torch/csrc/probes.cu"
# The TPU probe kernels each probe kernel replaces (body, then every launch).
PROBES_REPLACES = {
    "probe_copy": "scripts/perf_call_floor.py:26",
    "probe_matmul": "scripts/perf_call_floor.py:49",
    "probe_ablate": "scripts/perf_flash_ceiling.py:116",
}
PROBES_SITES = {
    "probe_copy": ["scripts/perf_call_floor.py:31", "scripts/perf_launch_audit.py:160"],
    "probe_matmul": ["scripts/perf_call_floor.py:56", "scripts/perf_call_floor.py:77"],
    "probe_ablate": ["scripts/perf_flash_ceiling.py:147", "scripts/perf_flash_ceiling2.py:146"],
}
# The probes against their plain versions: the matmul's and the ablation's
# outputs round to bf16 after fp32 sums in another order (the ablation's
# plain version in the kernel's own order, ops/probes.py::
# ablate_probe_online_reference; its distance from the TPU kernel's order is
# reported beside it and bounded on the CPU by tests/test_torch_probes.py).
PROBE_TOL = 2.0**-7
# The launch audit's 1.4B decode shape, and its int4 sites (K, N, products a
# launch) at the token step's and the prefill's rows.
AUDIT = perf_launch_audit
INT4_SITES_1P4B = {"qkv": (2048, 2048, 3), "out": (2048, 2048, 1), "lm_head": (2048, 50304, 1)}
ROWS_1P4B = (AUDIT.B, AUDIT.B * AUDIT.PROMPT)
# Decode attention in the 1.4B generate: (query rows, index) of a token step
# halfway through and of the prefill chunk.
DECODE_1P4B = {"token step": (1, AUDIT.PROMPT + AUDIT.NEW // 2), "prefill": (AUDIT.PROMPT, 0)}
# The 1.4B prefill chunk against caches of 4 to 12 64-slot tiles, at index 0
# and as the cache's last chunk: where a split of a chunk starts to pay
# (ops/decode_attention.py::MIN_PIECE_TILES).
CHUNK_SWEEP_TILES = tuple(range(4, 13))
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


def decode_variants(dtype):
    """The (design, splits) launches a decode-attention check runs beside
    the public call: each design the dtype takes (the tensor cores take bf16
    only), in one piece and in ``CHECK_SPLITS``."""
    designs = ("tensor_core", "cuda_core") if dtype == torch.bfloat16 else ("cuda_core",)
    return [(design, splits) for design in designs for splits in (1, CHECK_SPLITS)]


def variant_name(design, splits) -> str:
    return "public" if design is None else f"{design}/{splits}"


def kernel_case(name, gen, dtype, *, b, s, n, n_kv, h, length, index,
                window=None, fold=False, write_enable=None, int8=False, variants=None):
    """Decode attention against its plain version on the card, through the
    public call and in every ``decode_variants`` launch (or each
    ``(design, splits)`` of ``variants``) on the same inputs (each from the
    same caches) → the largest max abs error. ``int8``:
    quantized caches with their scales (and new-token scales when folded).
    A folded write must equal the plain version's bit for bit."""
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

    def call(fn, bufs, **extra):
        scales = {k: bufs[k] for k in ("k_scale", "v_scale") if k in bufs}
        out = fn(q, bufs["k_cache"], bufs["v_cache"], index, **scales, **kw, **extra)
        return out[0] if fold else out

    ref_caches = {k: v.clone() for k, v in caches.items()}
    ref = call(decode_attention_reference, ref_caches)
    label = f"{name}{' int8' if int8 else ''} {str(dtype)[6:]}"
    errs = {}
    for design, splits in [(None, None)] + (variants or decode_variants(dtype)):
        bufs = {k: v.clone() for k, v in caches.items()}
        out = call(decode_attention, bufs, design=design, splits=splits)
        torch.cuda.synchronize()
        vname = variant_name(design, splits)
        if fold:
            for key in caches:
                if not torch.equal(bufs[key], ref_caches[key]):
                    raise AssertionError(f"{label} {vname}: folded write of {key} differs from "
                                         f"the plain version")
            idx = index.expand(b).tolist()
            enabled = ([True] * b if write_enable is None else
                       [bool(e) for e in write_enable.tolist()])
            written = {"k_cache": "k_new", "v_cache": "v_new", "k_scale": "ks_new",
                       "v_scale": "vs_new"}
            for row in range(b):
                for key, buf in bufs.items():
                    if enabled[row]:
                        if not torch.equal(buf[row, :, idx[row]], new[written[key]][row, :, 0]):
                            raise AssertionError(f"{label} {vname}: row {row} slot of {key} not "
                                                 f"written")
                    elif not torch.equal(buf[row], caches[key][row]):
                        raise AssertionError(f"{label} {vname}: disabled row {row} {key} changed")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{label} {vname}: non-finite output")
        errs[vname] = (out.float() - ref.float()).abs().max().item()
    log(f"[kernel] {label}: max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {TOL[dtype]:g})")
    bad = {k: v for k, v in errs.items() if not v <= TOL[dtype]}
    if bad:
        raise AssertionError(f"{label}: max abs err {bad} > {TOL[dtype]}")
    return max(errs.values())


def check_kernel(gen, *, int8=False):
    """Decode attention against its plain version at the 125M prefill
    (S=128) and decode (S=1, index 200) shapes, a ragged folded write with
    one row disabled, GQA + window at H=128, a GQA-4 windowed token step
    with a ragged folded write, an MQA token step of 16 folded rows (the
    tensor-core design's least) with a folded write, and a 10-row chunk;
    float caches, or int8 ones with their scales."""
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
            kernel_case("gqa4_window_fold", gen, dtype, b=B, s=1, n=16, n_kv=4, h=64,
                        length=512, index=row_index % 512, window=100, fold=True,
                        write_enable=enable, int8=int8),
            kernel_case("mqa16_fold", gen, dtype, b=4, s=1, n=16, n_kv=1, h=128, length=768,
                        index=row_index[:4] % 768, fold=True, write_enable=enable[B // 2:],
                        int8=int8),
            kernel_case("chunk10", gen, dtype, b=2, s=5, n=4, n_kv=2, h=64, length=1024,
                        index=row_index[:2] % 1000, int8=int8),
        ]
        if int8:
            cases.append(kernel_case("decode_fold", gen, dtype, s=1, index=zero + 200,
                                     fold=True, **mha))
        errs[dtype] = max(cases)
    return errs


def paged_case(name, gen, dtype, *, b, s, n, n_kv, h, page, t_cap, lo, hi, shared,
               fold=False, window=None, int8=False):
    """The paged kernel against its plain version, and against the
    contiguous kernel on the same values permuted into pages, through the
    public call and in every ``decode_variants`` launch → the largest max
    abs error against the plain version. Row indices are drawn from [lo, hi).
    Rows 0 and 1 share their first ``shared`` pages (a prefix cache); every
    other mapped page is private, in a shuffled order; table entries past a
    row's frontier name the scratch page 0, and unmapped pool pages hold
    seeded noise. In each launch the paged output (and, folded, the written
    values) must be bit-equal to the contiguous kernel's in the same design
    and split, and a folded write must change no pool slot but the enabled
    rows' mapped write slots."""
    length = t_cap * page
    idx = torch.randint(lo, hi, (b,), generator=gen, device="cuda", dtype=torch.int32)
    q = randn(gen, b, s, n, h, dtype=dtype)
    if int8:
        (kc, ks), (vc, vs) = (int8_kv(gen, b, n_kv, length, h) for _ in range(2))
        contig = {"k_cache": kc, "v_cache": vc, "k_scale": ks, "v_scale": vs}
    else:
        contig = {"k_cache": randn(gen, b, n_kv, length, h, dtype=dtype),
                  "v_cache": randn(gen, b, n_kv, length, h, dtype=dtype)}
    for t in contig.values():
        t[1, :, : shared * page] = t[0, :, : shared * page]
    n_pages = 1 + b * t_cap + 3
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda")[: b * t_cap] + 1
    table = perm.view(b, t_cap).to(torch.int32)
    table[1, :shared] = table[0, :shared]
    frontier = (idx + s - 1) // page
    table[torch.arange(t_cap, device="cuda")[None, :] > frontier[:, None]] = 0
    mapped = table > 0
    pools = {}
    for key, t in contig.items():
        if t.dtype == torch.int8:
            pool = torch.randint(-127, 128, (n_pages, n_kv, page, h), generator=gen,
                                 device="cuda", dtype=torch.int8)
        elif key.endswith("scale"):
            pool = torch.rand(n_pages, n_kv, page, generator=gen, device="cuda") / 64
        else:
            pool = randn(gen, n_pages, n_kv, page, h, dtype=dtype)
        paged = t.view(b, n_kv, t_cap, page, *t.shape[3:]).transpose(1, 2)
        pool[table[mapped].long()] = paged[mapped]
        pools[key] = pool
    kw = dict(window=window)
    new = {}
    if fold:
        if int8:
            (new["k_new"], new["ks_new"]), (new["v_new"], new["vs_new"]) = (
                int8_kv(gen, b, n_kv, 1, h) for _ in range(2))
        else:
            new = {"k_new": randn(gen, b, n_kv, 1, h, dtype=dtype),
                   "v_new": randn(gen, b, n_kv, 1, h, dtype=dtype)}
        enable = torch.ones(b, dtype=torch.int32, device="cuda")
        enable[b // 2] = 0
        kw.update(new, write_enable=enable)
    ref_pools = {k: v.clone() for k, v in pools.items()}

    def run(fn, caches, **extra):
        scales = {k: caches[k] for k in ("k_scale", "v_scale") if k in caches}
        out = fn(q, caches["k_cache"], caches["v_cache"], idx, **scales, **kw, **extra)
        return out[0] if fold else out

    ref = run(decode_attention_reference, ref_pools, block_table=table)
    label = f"paged {name}{' int8' if int8 else ''} {str(dtype)[6:]}"
    errs = {}
    for design, splits in [(None, None)] + decode_variants(dtype):
        vname = variant_name(design, splits)
        variant = dict(design=design, splits=splits)
        bufs = {k: v.clone() for k, v in pools.items()}
        cbufs = {k: v.clone() for k, v in contig.items()}
        out = run(decode_attention, bufs, block_table=table, block_k=page, **variant)
        out_c = run(decode_attention, cbufs, **variant)
        torch.cuda.synchronize()
        if not torch.equal(out, out_c):
            raise AssertionError(f"{label} {vname}: output differs from the contiguous kernel's")
        for key, pool in bufs.items():
            paged = cbufs[key].view(b, n_kv, t_cap, page, *contig[key].shape[3:]).transpose(1, 2)
            if not torch.equal(pool[table[mapped].long()], paged[mapped]):
                raise AssertionError(f"{label} {vname}: {key} pages differ from the contiguous "
                                     f"kernel's cache")
            if fold:
                if not torch.equal(pool, ref_pools[key]):
                    raise AssertionError(f"{label} {vname}: folded write of {key} differs from "
                                         f"the plain version")
                allowed = torch.zeros(n_pages, page, dtype=torch.bool, device="cuda")
                rows = enable.nonzero()[:, 0]
                at = idx[rows].long()
                allowed[table[rows, at // page].long(), at % page] = True
                changed = (pool != pools[key]).transpose(1, 2).reshape(n_pages, page, -1).any(-1)
                if (changed & ~allowed).any():
                    raise AssertionError(f"{label} {vname}: {key} changed outside the enabled "
                                         f"write slots")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{label} {vname}: non-finite output")
        errs[vname] = (out.float() - ref.float()).abs().max().item()
    log(f"[kernel] {label}: bit-equal to the contiguous kernel in every launch; max abs err "
        f"against the plain version " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {TOL[dtype]:g})")
    bad = {k: v for k, v in errs.items() if not v <= TOL[dtype]}
    if bad:
        raise AssertionError(f"{label}: max abs err {bad} > {TOL[dtype]}")
    return max(errs.values())


# The paged kernel checks: the engine's decode (ragged fold, page 64, rows at
# 544-575 sharing an 8-page prefix) and prefill (S=64 at 512) shapes, GQA +
# window at H=128 with 16-slot pages, 128-slot pages at H=128, and a
# windowed GQA chunk over 8-slot pages.
PAGED_CASES = {
    "engine_decode p64": dict(b=8, s=1, n=12, n_kv=12, h=64, page=64, t_cap=16, lo=544,
                              hi=576, shared=8, fold=True),
    "engine_prefill p64": dict(b=8, s=64, n=12, n_kv=12, h=64, page=64, t_cap=16, lo=512,
                               hi=513, shared=8),
    "gqa_window p16 h128": dict(b=4, s=1, n=16, n_kv=8, h=128, page=16, t_cap=32, lo=100,
                                hi=400, shared=2, fold=True, window=64),
    "prefill p128 h128": dict(b=2, s=64, n=4, n_kv=4, h=128, page=128, t_cap=4, lo=200,
                              hi=300, shared=1),
    "gqa_chunk_window p8": dict(b=3, s=64, n=8, n_kv=4, h=64, page=8, t_cap=32, lo=40,
                                hi=150, shared=2, window=48),
}


def check_paged(gen):
    """Every ``PAGED_CASES`` shape in fp32 and bf16, float and int8 caches
    → the largest error against the plain version per (dtype, int8)."""
    return {(dtype, int8): max(paged_case(name, gen, dtype, int8=int8, **kw)
                               for name, kw in PAGED_CASES.items())
            for dtype in (torch.float32, torch.bfloat16) for int8 in (False, True)}


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
    """The three flash kernels against their plain versions on one shape, in
    every design of ``FLASH_DESIGNS[dtype]`` → errors by design: fwd
    ``out``/``lse`` absolute, bwd grads relative to the largest reference
    magnitude, and each absolute. The backward pair gets the plain forward's
    ``out``/``lse``, so each kernel is held on the same inputs; the public
    backward runs once more on the public forward's ``out``/``lse``, as the
    train step chains them (``"chained"``). The public ``_fwd``/``_bwd``
    must launch the design ``_fwd_design``/``_bwd_design`` names; the other
    design runs through ``design=``."""
    group, s_kv = n // n_kv, s if s_kv is None else s_kv
    q = fold_rows(randn(gen, b, s, n, h, dtype=dtype), group)
    k = fold_rows(randn(gen, b, s_kv, n_kv, h, dtype=dtype), 1)
    v = fold_rows(randn(gen, b, s_kv, n_kv, h, dtype=dtype), 1)
    do = randn(gen, *q.shape, dtype=dtype)
    kw = dict(scale=h**-0.5, causal=causal, window=window, group=group)
    ref_out, ref_lse = flash.flash_attention_fwd_reference(q, k, v, **kw)
    ref_grads = flash.flash_attention_bwd_reference(q, k, v, ref_out, ref_lse, do, **kw)
    fwd_args = (q, k, v, kw["scale"], causal, window, group)
    bwd_tail = (do, kw["scale"], causal, window, group)
    public = {"fwd": flash._fwd_design(dtype, h), "bwd": flash._bwd_design(dtype, h)}
    tol = FLASH_TOL[dtype]

    def counted(kind, design, *args):
        """``flash._fwd`` or ``flash._bwd`` (``kind``) through the public path
        when ``design`` is the one its rule picks, else forced onto it; each
        of its kernels must launch once, on ``design``."""
        run, kernels = (flash._fwd, ("fwd",)) if kind == "fwd" else (flash._bwd,
                                                                     ("bwd_dkv", "bwd_dq"))
        forced = {} if design == public[kind] else {"design": design}
        before = dict(flash.flash_attention.launches)
        result = run(*args, **forced)
        torch.cuda.synchronize()
        moved = {key: flash.flash_attention.launches[key] - before[key] for key in before}
        for kernel in kernels:
            if (moved[kernel], moved[f"{kernel}_tensor_core"]) != (1, int(design == "tensor_core")):
                raise AssertionError(f"flash {name} {dtype} {design}: launches moved {moved}")
        return result

    def grad_errs(label, grads, errs, abs_errs):
        for gname, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
            if not torch.isfinite(got).all():
                raise AssertionError(f"flash {name} {dtype} {label}: non-finite {gname}")
            abs_errs[gname] = (got.float() - want.float()).abs().max().item()
            errs[gname] = abs_errs[gname] / want.float().abs().max().item()
        log(f"[flash] {name} {str(dtype)[6:]} {label}: " + ", ".join(
            f"{k} {v:.3e} (tol {tol[k]:g})" for k, v in errs.items()))
        bad = {k: v for k, v in errs.items() if not v <= tol[k]}
        if bad:
            raise AssertionError(f"flash {name} {dtype} {label}: errors {bad} over {tol}")
        return errs, abs_errs

    results = {}
    for design in FLASH_DESIGNS[dtype]:
        out, lse = counted("fwd", design, *fwd_args)
        grads = counted("bwd", design, q, k, v, ref_out, ref_lse, *bwd_tail)
        fwd_errs = {"out": (out.float() - ref_out.float()).abs().max().item(),
                    "lse": (lse - ref_lse).abs().max().item()}
        label = f"fwd+bwd {design}{' (public)' if design == public['bwd'] else ''}"
        results[design] = grad_errs(label, grads, dict(fwd_errs), dict(fwd_errs))
        if design == public["fwd"]:
            chained = flash._bwd(q, k, v, out, lse, *bwd_tail)
            results["chained"] = grad_errs(f"bwd {public['bwd']} on this forward's out/lse",
                                           chained, dict(fwd_errs), dict(fwd_errs))
    return results


def check_flash(gen):
    """``FLASH_SHAPES`` in fp32 and bf16, the three kernels in every design of
    ``FLASH_DESIGNS``: (a) the 125M train step, (b) non-causal (case6), (c)
    GQA + window at H=128 (fully masked rows at tile edges), (d) a partial
    tile, (e) unequal q/kv lengths, (f) GQA 8 with a 48-key window and
    partial tiles, (g) H=128 causal → the largest error of each kernel per
    (dtype, design), as checked and absolute (``"chained"``: the public
    backward on the public forward's out/lse)."""
    outputs = {"fwd": ("out", "lse"), "bwd_dkv": ("dk", "dv"), "bwd_dq": ("dq",)}
    worst = {}
    for dtype, designs in FLASH_DESIGNS.items():
        cases = [flash_case(name, gen, dtype, **kw) for name, kw in FLASH_SHAPES.items()]
        for design in (*designs, "chained"):
            for which, idx in (("checked", 0), ("abs", 1)):
                worst[dtype, design, which] = {
                    kernel: max(c[design][idx][o] for c in cases for o in outs)
                    for kernel, outs in outputs.items()
                }
        log(f"[flash] {str(dtype)[6:]} forward, worst |error| of out and lse over "
            f"{len(cases)} shapes: " + "; ".join(f"{d} {worst[dtype, d, 'abs']['fwd']:.3e}"
                                                 for d in designs)
            + f" (tol {FLASH_TOL[dtype]['out']:g})")
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


def generate_decode_launches(cfg, b=B, prompt=PROMPT, new=NEW) -> dict:
    """Decode attention's tensor-core and split launches in one rectangular
    generate (b, prompt, +new) as the wrapper's rules give them: the
    prefill's launches (prompt · group folded rows) on the tensor cores,
    every token step's split. Raises if the rules would leave the token
    step in one piece."""
    layers, n_kv = cfg.num_layers, cfg.num_kv_heads or cfg.num_heads
    h = cfg.head_dim
    prefill = public_split(b, prompt, cfg.num_heads, n_kv, h, cfg.max_seq_len)
    step = public_split(b, 1, cfg.num_heads, n_kv, h, cfg.max_seq_len)
    if prefill[0] != "tensor_core" or step[1] == 1:
        raise AssertionError(f"decode attention rules: prefill {prefill}, token step {step}")
    return {"decode_attention_tensor_core": layers,
            "decode_attention_split": layers * (new - 1) + layers * (prefill[1] > 1)}


def check_generate_designs(label, cfg) -> dict:
    """Hold decode attention's counters after one counted rectangular
    generate to ``generate_decode_launches``."""
    want = generate_decode_launches(cfg)
    got = {"decode_attention_tensor_core": decode_attention.tensor_core_launches,
           "decode_attention_split": decode_attention.split_launches}
    log(f"[main] {label}: decode attention {got} (want {want}: the prefill on the tensor "
        f"cores, every token step split)")
    if got != want:
        raise AssertionError(f"{label} generate: decode attention launches {got}, want {want}")
    return got


def run_main_path(params, gen, tf_model, card):
    """Rectangular and ragged+EOS generation through make_generate_fn."""
    vocab = CONFIG_125M.vocab_size
    prompt = torch.randint(0, vocab, (B, PROMPT), generator=gen, device="cuda",
                           dtype=torch.int32)
    rect = make_generate_fn(CONFIG_125M, max_new_tokens=NEW, inference_dtype=torch.bfloat16)
    rect(params, prompt)                                     # warm-up
    torch.cuda.synchronize()
    reset_launches()
    out = rect(params, prompt)
    torch.cuda.synchronize()
    rect_launches = decode_attention.launches
    designs = check_generate_designs("rectangular", CONFIG_125M)
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
                tok_s=tok_s, ms_per_step=sec / NEW * 1e3, gap=max(gap, gap_r), **designs)


def profile_summary(label, run, steps, ms_per_step):
    """Where a step's time goes: ``run()`` (``steps`` steps) once under
    torch.profiler (``utils/bench.py::device_profile``) → device kernels per
    step, device-busy time per step, the idle share against the unprofiled
    ms/step, the top 6 kernels, and the port's own kernels
    (``PORT_KERNELS``), each per step."""
    prof = device_profile(run, steps)
    busy_ms = prof["busy_ms"]
    top = [(name[:60], round(ms, 4)) for name, ms in prof["by_name"].most_common(6)]
    ported = {name: round(ms, 4) for name, ms in prof["port_ms_by_name"].items()}
    row = dict(kernels_per_step=prof["kernels"], busy_ms_per_step=busy_ms,
               idle_share=1 - busy_ms / ms_per_step, top_ms_per_step=top,
               port_kernels_ms_per_step=ported)
    log(f"[profile] {label}, per step: {row['kernels_per_step']:.1f} device kernels, "
        f"device busy {busy_ms:.3f} ms of {ms_per_step:.3f} ms unprofiled "
        f"(idle share {row['idle_share']:.3f}); top: {top}; the port's kernels: {ported}")
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
    log(f"[main] 125M train step, one {K_STEPS}-step call: launches {launches} (want {want} "
        f"each, every launch on the tensor-core design)")
    if launches != dict.fromkeys(FLASH_LAUNCH_KEYS, want):
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
    with the plain-norm step's and with both steps' flash backward, and
    then their flash forward, forced onto the CUDA-core design (every round
    times each once; medians of 3); a profile."""
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
        f"{norm} (want {want_norm}), flash {flash_launches} (want {want_flash} each, every "
        f"launch on the tensor-core design)")
    if norm != want_norm:
        raise AssertionError(f"one fused-norm {K_STEPS}-step call launched {norm}, want {want_norm}")
    if flash_launches != dict.fromkeys(FLASH_LAUNCH_KEYS, want_flash):
        raise AssertionError(f"one fused-norm {K_STEPS}-step call launched flash {flash_launches}")
    if call_losses.shape != (K_STEPS,) or not torch.isfinite(call_losses).all():
        raise AssertionError(f"the fused-norm {K_STEPS}-step call returned {call_losses}")

    # Each norm's step again with the flash backward, and with the flash
    # forward, forced onto the CUDA-core design: the in-run end-to-end
    # comparison of each kernel's two designs.
    calls = {name: functools.partial(multi, state, stacked) for name, state in states.items()}
    secs = interleaved_seconds(
        {**calls, **{f"{name}, cuda-core flash {kind}": on_design(call, "cuda_core", flash,
                                                                  f"_{kind}_design")
                     for kind in ("bwd", "fwd") for name, call in calls.items()}})
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
    once in turn, every other round in reverse order (no variant always
    runs first, or always right after the same other one)."""
    times = {name: [] for name in calls}
    for r in range(rounds):
        for name, call in (list(calls.items())[::-1] if r % 2 else calls.items()):
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
    reset_launches()
    out = fns["int8_cache"](params, prompt)
    torch.cuda.synchronize()
    launches = decode_attention.launches
    check_generate_designs("int8 KV cache", cfg)
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


def time_flash(gen, card):
    """Each flash kernel at the train step's attention shape (folded q (96,
    1024, 64) bf16, causal), queued (``queued_time``), in both designs on
    the same inputs, beside the bound, the plain versions and SDPA (queued
    too), with each kernel's TFLOP/s."""
    b, s, n, h, scale = TRAIN_B, TRAIN_S, 12, 64, 64**-0.5
    q, k, v, do = (fold_rows(randn(gen, b, s, n, h, dtype=torch.bfloat16), 1)
                   for _ in range(4))
    out, lse = flash._fwd(q, k, v, scale, True, None, 1)
    delta = flash._delta(out, do)
    dq, dk, dv, out2, lse2 = map(torch.empty_like, (q, k, v, out, lse))
    common = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    args = (q, k, scale, True, None, 1)
    launch = {
        "fwd": lambda design: flash._launch(
            "fwd", [t.data_ptr() for t in (q, k, v, out2, lse2)], *args, design),
        "bwd_dkv": lambda design: flash._launch(
            "bwd_dkv", common + [dk.data_ptr(), dv.data_ptr()], *args, design),
        "bwd_dq": lambda design: flash._launch(
            "bwd_dq", common + [dq.data_ptr()], *args, design),
    }
    kw = dict(scale=scale, causal=True)
    plain_fwd = time_fn(flash.flash_attention_fwd_reference, q, k, v, repeats=5, inner=3, **kw)
    plain_bwd = time_fn(flash.flash_attention_bwd_reference, q, k, v, out, lse, do,
                        repeats=5, inner=3, **kw)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (x.view(b, n, s, h).detach().requires_grad_() for x in (q, k, v))
    lib_fwd, _ = queued_time(sdpa, qs, ks, vs, is_causal=True, inner=10)
    lib_out = sdpa(qs, ks, vs, is_causal=True)
    lib_bwd, _ = queued_time(torch.autograd.grad, lib_out, (qs, ks, vs), do.view(b, n, s, h),
                             retain_graph=True, inner=10)
    lib_fwd_bwd, _ = queued_time(lambda: torch.autograd.grad(
        sdpa(qs, ks, vs, is_causal=True), (qs, ks, vs), do.view(b, n, s, h)), inner=10)

    pairs = int(flash._keep_mask(s, s, 1, True, None, q.device).sum()) * b * n
    tensor, rowvec = q.numel() * q.element_size(), lse.numel() * 4
    work = {   # (bytes read once + written once, FLOPs)
        "fwd": (4 * tensor + rowvec, 4 * h * pairs),
        "bwd_dkv": (6 * tensor + 2 * rowvec, 8 * h * pairs),
        "bwd_dq": (5 * tensor + 2 * rowvec, 6 * h * pairs),
    }
    rows = {}
    for name, run in launch.items():
        bound_ms, by = bound(*work[name])
        public = (flash._fwd_design if name == "fwd" else flash._bwd_design)(torch.bfloat16, h)
        designs = (public, "cuda_core")
        ms = {d: queued_time(run, d, inner=10)[0] * 1e3 for d in designs}
        rows[name] = dict(
            ms=ms[designs[0]], bound_ms=bound_ms, bound_by=by,
            plain_ms=(plain_fwd if name == "fwd" else plain_bwd) * 1e3,
            library_ms=(lib_fwd if name == "fwd" else lib_bwd) * 1e3,
            bytes=work[name][0], ops=work[name][1],
            tflop_s=work[name][1] / ms[designs[0]] / 1e9, design=public,
            cuda_core_ms=ms["cuda_core"], cuda_core_tflop_s=work[name][1] / ms["cuda_core"] / 1e9,
        )
        log(f"[time] flash {name} (folded q {tuple(q.shape)}, causal, bf16, queued): "
            + ", ".join(f"{d} {ms[d] * 1e3:.2f} us ({work[name][1] / ms[d] / 1e9:.1f} TFLOP/s)"
                        for d in designs)
            + f"; bound {bound_ms * 1e3:.2f} us ({by}), plain {rows[name]['plain_ms'] * 1e3:.2f}"
            f" us, sdpa {rows[name]['library_ms'] * 1e3:.2f} us")
    log(f"[time] sdpa {tuple(qs.shape)} bf16 causal, queued: fwd {lib_fwd * 1e6:.2f} us, bwd "
        f"{lib_bwd * 1e6:.2f} us, fwd+bwd {lib_fwd_bwd * 1e6:.2f} us; the plain backward "
        f"computes dq, dk and dv together ({plain_bwd * 1e6:.2f} us) on {card}")
    return rows, dict(sdpa_fwd_ms=lib_fwd * 1e3, sdpa_bwd_ms=lib_bwd * 1e3,
                      sdpa_fwd_bwd_ms=lib_fwd_bwd * 1e3)


def public_split(b, s, n, n_kv, h, length, dtype=torch.bfloat16):
    """The design and split ``decode_attention`` takes at a shape."""
    return da._plan(dtype, b, s, n, n_kv, h, length)[:2]


def time_designs(args, kw, shape):
    """Queued times (µs) of decode attention on ``args``/``kw``: the public
    call, the first design (``cuda_core`` in one piece) and the public
    design at every ``SPLIT_SWEEP`` split, beside the plain version. Returns
    (row, samples enqueued past the sleep)."""
    design, splits = public_split(*shape)
    ms, late = queued_time(decode_attention, *args, **kw)
    old_ms, old_late = queued_time(decode_attention, *args, design="cuda_core", splits=1, **kw)
    sweep = {sp: queued_time(decode_attention, *args, design=design, splits=sp, **kw)[0] * 1e3
             for sp in SPLIT_SWEEP}
    plain_ms, _ = queued_time(decode_attention_reference, *args, inner=3, repeats=5, **kw)
    return dict(ms=ms * 1e3, design=design, splits=splits, cuda_core_design_ms=old_ms * 1e3,
                split_sweep_ms=sweep, plain_ms=plain_ms * 1e3), late + old_late


def time_shape(gen, name, *, s, index, card, n=12, h=64, length=1024):
    """Decode attention at one generate shape (b=8, by default 12 heads,
    H=64, bf16 1024-slot caches, one index), queued (device time): the
    public call, the first design on the same inputs, the split sweep, the
    plain version, SDPA on the valid prefix (causal for a chunk) and the
    bound (bytes: the valid K/V prefix, q and out)."""
    dtype = torch.bfloat16
    q = randn(gen, B, s, n, h, dtype=dtype)
    kc = randn(gen, B, n, length, h, dtype=dtype)
    vc = randn(gen, B, n, length, h, dtype=dtype)
    idx = torch.full((), index, dtype=torch.int32, device="cuda")
    row, late = time_designs((q, kc, vc, idx), {}, (B, s, n, n, h, length))
    valid = index + s
    qt, kt, vt = q.transpose(1, 2).contiguous(), kc[:, :, :valid], vc[:, :, :valid]
    library_ms, _ = queued_time(torch.nn.functional.scaled_dot_product_attention, qt, kt, vt,
                                is_causal=s > 1)
    itemsize = q.element_size()
    nbytes = 2 * q.numel() * itemsize + 2 * B * n * valid * h * itemsize
    pairs = s * index + s * (s + 1) // 2        # (query, key) pairs per (b, head)
    ops = 4 * h * pairs * B * n
    bound_ms, bound_by = bound(nbytes, ops)
    row.update(bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms * 1e3, bytes=nbytes,
               ops=ops, late_samples=late)
    log(f"[time] decode_attention {name} (q {tuple(q.shape)}, index {index}, bf16, queued): "
        f"{row['design']}/{row['splits']} {row['ms'] * 1e3:.2f} us, cuda_core/1 (the first "
        f"design) {row['cuda_core_design_ms'] * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
        f"({bound_by}), plain {row['plain_ms'] * 1e3:.2f} us, sdpa {library_ms * 1e6:.2f} us; "
        f"{row['design']} by splits " + ", ".join(
            f"{k}: {v * 1e3:.2f}" for k, v in row["split_sweep_ms"].items())
        + f" us on {card}" + (f" ({late} samples enqueued past the sleep)" if late else ""))
    return row


def cold_time(calls, repeats=5):
    """``queued_time`` for calls that each read their own copy of the
    weights: one sample runs every call once, in turn, so that the copies
    (together larger than the 50 MB L2, ``COLD_BYTES``) leave each call
    to read its weights from HBM. Returns (median seconds per call, samples
    whose enqueue outlasted the sleep)."""
    for call in calls[:3]:
        call()
    torch.cuda.synchronize()
    samples, late = [], 0
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)        # ~20 ms: the enqueue of a few hundred calls
        start.record()
        for call in calls:
            call()
        late += bool(start.query())
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 1e3 / len(calls))
    return statistics.median(samples), late


def copies_past_l2(nbytes: int) -> int:
    """Copies of ``nbytes`` of weights that together exceed ``COLD_BYTES``."""
    return max(2, -(-COLD_BYTES // nbytes))


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
        old_ms, _ = queued_time(decode_attention, *args, design="cuda_core", splits=1, **kw)
        plain_ms, _ = queued_time(decode_attention_reference, *args, inner=3, repeats=5, **kw)
        nbytes = qbytes + 2 * B * n * valid * per_slot
        bound_ms, by = bound(nbytes, ops)
        design, splits = public_split(B, 1, n, n, h, length)
        rows[name] = dict(ms=ms * 1e3, plain_ms=plain_ms * 1e3, bound_ms=bound_ms, bound_by=by,
                          library_ms=lib_ms * 1e3, bytes=nbytes, ops=ops, late_samples=late,
                          design=design, splits=splits, cuda_core_design_ms=old_ms * 1e3)
        log(f"[time] decode_attention decode {name} cache (q {tuple(q.shape)}, index {index}, "
            f"queued): {design}/{splits} {ms * 1e6:.2f} us, cuda_core/1 (the first design) "
            f"{old_ms * 1e6:.2f} us, bound {bound_ms * 1e3:.2f} us ({by}, "
            f"{nbytes / 1e6:.2f} MB), plain {plain_ms * 1e6:.2f} us, sdpa bf16 "
            f"{lib_ms * 1e6:.2f} us on {card}")
    return rows


def time_paged(gen, card):
    """Decode attention over page pools at the engine's token-step shape
    (b=8, S=1, rows at 544-575, 64-slot pages) and refill shape (S=64 at
    512), bf16, queued (device time): the public call, the first design
    and the split sweep on the pools, the public call on a contiguous cache
    of the same values, the plain paged version, the bound (bytes: each
    row's valid K/V prefix read once, q, out, the index and the table) and
    SDPA on the same bf16 values (each row's valid prefix as a boolean
    mask) as the yardstick."""
    n, h, page, t_cap = 12, 64, 64, 16
    length = page * t_cap
    n_pages = 1 + B * t_cap
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, s, lo, hi in (("decode", 1, 544, 576), ("prefill", PAGED_CHUNK, 512, 513)):
        idx = torch.randint(lo, hi, (B,), generator=gen, device="cuda", dtype=torch.int32)
        q = randn(gen, B, s, n, h, dtype=torch.bfloat16)
        kc, vc = (randn(gen, B, n, length, h, dtype=torch.bfloat16) for _ in range(2))
        table = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1).view(
            B, t_cap).to(torch.int32)
        pools = []
        for c in (kc, vc):
            pool = torch.zeros(n_pages, n, page, h, dtype=torch.bfloat16, device="cuda")
            pool[table.long()] = c.view(B, n, t_cap, page, h).transpose(1, 2)
            pools.append(pool)
        row, late = time_designs((q, *pools, idx), dict(block_table=table),
                                 (B, s, n, n, h, length))
        contig_ms, contig_late = queued_time(decode_attention, q, kc, vc, idx)
        valid = int((idx + s).max())
        qpos = idx[:, None].long() + torch.arange(s, device="cuda")
        mask = (torch.arange(valid, device="cuda")[None, None, :] <= qpos[:, :, None])[:, None]
        lib_ms, _ = queued_time(sdpa, q.transpose(1, 2).contiguous(), kc[:, :, :valid],
                                vc[:, :, :valid], attn_mask=mask)
        prefix = int((idx + s).sum())                    # valid slots over the rows
        nbytes = 2 * q.numel() * 2 + 2 * n * h * 2 * prefix + table.numel() * 4 + B * 4
        pairs = int((s * idx.long() + s * (s + 1) // 2).sum())
        ops = 4 * h * pairs * n
        bound_ms, by = bound(nbytes, ops)
        late += contig_late
        row.update(contiguous_ms=contig_ms * 1e3, library_ms=lib_ms * 1e3, bound_ms=bound_ms,
                   bound_by=by, bytes=nbytes, ops=ops, late_samples=late, index=idx.tolist())
        rows[name] = row
        log(f"[time] decode_attention paged {name} (q {tuple(q.shape)}, index "
            f"{min(idx.tolist())}-{max(idx.tolist())}, page {page}, bf16, queued): "
            f"{row['design']}/{row['splits']} {row['ms'] * 1e3:.2f} us, cuda_core/1 (the first "
            f"design) {row['cuda_core_design_ms'] * 1e3:.2f} us, contiguous {contig_ms * 1e6:.2f}"
            f" us, bound {bound_ms * 1e3:.2f} us ({by}, {nbytes / 1e6:.2f} MB), plain "
            f"{row['plain_ms'] * 1e3:.2f} us, sdpa {lib_ms * 1e6:.2f} us; {row['design']} by "
            f"splits " + ", ".join(f"{k}: {v * 1e3:.2f}" for k, v in row["split_sweep_ms"].items())
            + f" us on {card}" + (f" ({late} samples enqueued past the sleep)" if late else ""))
    return rows


def time_decode_designs(gen, card):
    """Decode attention at the four main-path shapes, each in its public
    design and split beside the first design: generate's prefill (S=128 at
    0) and token step (S=1 at 200), the engine's refill (S=64 at 512) and
    token step (rows at 544-575) over 64-slot pages."""
    shapes = {"prefill": time_shape(gen, "prefill", s=PROMPT, index=0, card=card),
              "decode": time_shape(gen, "decode", s=1, index=200, card=card)}
    paged = time_paged(gen, card)
    shapes.update({"paged_refill": paged["prefill"], "paged_decode": paged["decode"]})
    return shapes


def engine_prompts():
    """``bench.py::bench_serving_125m``'s queue: 24 requests, each a shared
    512-token system prompt plus 32 tokens of its own, from numpy seed 0."""
    rng = np.random.default_rng(0)
    vocab = CONFIG_125M.vocab_size
    system = rng.integers(1, vocab, size=(ENGINE_SYSTEM,)).astype(np.int32)
    return [np.concatenate([system, rng.integers(1, vocab, size=(ENGINE_OWN,)).astype(np.int32)])
            for _ in range(ENGINE_REQUESTS)]


def engine_gap(model, outs):
    """Teacher-forced gap of every request's generated tokens under a dense
    forward, eight requests at a time."""
    start = ENGINE_SYSTEM + ENGINE_OWN
    gap = 0.0
    for i in range(0, len(outs), B):
        batch = torch.as_tensor(np.stack(outs[i:i + B]), device="cuda")
        rows = batch.shape[0]
        gap = max(gap, teacher_forced_gap(model, batch, [start] * rows, [batch.shape[1]] * rows))
    return gap


def run_engine_path(params, q4, card):
    """``bench.py::bench_serving_125m`` on the port's continuous engine: the
    125M model at full width and depth (seeded random weights), bf16, 24
    requests of 544 tokens through 8 slots, +32 greedy tokens, refill chunk
    64, decode blocks of 32, chains of 9. Variants: unpaged; paged (93 pages
    of 64); paged with the prefix cache, cold (registry flushed) and warm;
    int4-fused + paged + prefix warm. Gates: every paged variant's tokens
    equal the unpaged engine's (the int4 one: the unpaged int4-fused
    engine's) request for request; every request's teacher-forced gap within
    0.1 of a dense forward; warm prefix hits 24 of 24 with 8 pages reused
    each; decode attention launched exactly once a layer per model call
    (paged launches only in the paged engines). Then every variant's serve
    timed interleaved (medians of 3) and one warm paged serve profiled."""
    cfg = dataclasses.replace(CONFIG_125M, decode_attention="blocked")
    prompts = engine_prompts()
    paged = dict(paged_pages=ENGINE_PAGES, page_size=ENGINE_PAGE)
    engines = {
        "unpaged": (make_continuous_engine(cfg, **ENGINE_COMMON), params),
        "paged": (make_continuous_engine(cfg, **ENGINE_COMMON, **paged), params),
        "paged+prefix": (make_continuous_engine(cfg, **ENGINE_COMMON, **paged,
                                                prefix_cache=True), params),
        "int4+paged+prefix": (make_continuous_engine(cfg, **ENGINE_COMMON, **paged,
                                                     prefix_cache=True, dequantize="fused"), q4),
    }
    int4_unpaged = make_continuous_engine(cfg, **ENGINE_COMMON, dequantize="fused")
    for serve, tree in engines.values():
        serve(tree, prompts[:B])                            # warm-up
    torch.cuda.synchronize()
    runs = {}

    def run(label, serve, tree, *, cold=False):
        """One counted serve → its outputs, stats and launch counts."""
        if cold:
            serve.engine.flush_prefix_cache()
        forwards = serve.engine.model_forwards
        engine = serve.engine
        refills = []
        refill_step = engine._refill_step
        engine._refill_step = lambda *a: (refills.append(1), refill_step(*a))[1]
        torch.cuda.synchronize()
        reset_launches()
        try:
            outs = serve(tree, prompts)
            torch.cuda.synchronize()
        finally:
            del engine._refill_step
        launches = read_launches()
        calls = serve.engine.model_forwards - forwards
        runs[label] = dict(outs=outs, stats=serve.last_stats, latency=serve.last_latency,
                           launches=launches, model_forwards=calls, refill_calls=len(refills))
        want = cfg.num_layers * calls
        is_paged = serve.engine.last_stats is not None
        log(f"[engine] {label}: {calls} model calls ({len(refills)} refill chunks), decode "
            f"attention {launches['decode_attention']} launches "
            f"({launches['decode_attention_paged']} paged; want {want}; "
            f"{launches['decode_attention_tensor_core']} tensor-core, "
            f"{launches['decode_attention_split']} split), stats {serve.last_stats}")
        if launches["decode_attention"] != want or launches["decode_attention_paged"] != (
                want if is_paged else 0):
            raise AssertionError(f"engine {label}: launches {launches}, want {want}")
        # Refill chunks (S = 64) on the tensor cores, every token step split.
        steps = cfg.num_layers * (calls - len(refills))
        if (launches["decode_attention_tensor_core"] != cfg.num_layers * len(refills)
                or launches["decode_attention_split"] not in (steps, want)):
            raise AssertionError(f"engine {label}: decode attention launches {launches}, want "
                                 f"{cfg.num_layers * len(refills)} on the tensor cores and "
                                 f"every token step's split")
        if launches["int4_matmul3"]:
            # Refill chunks (8 x 64 rows) take the tensor-core design, decode
            # calls (8 rows) the small-M one: the triples a layer, the w4a16
            # launches (out-projections and the lm_head) a layer and one more.
            got = {k: launches[k] for k in (
                "int4_matmul3", "int4_matmul3_tensor_core", "int4_matmul3_small_m",
                "int4_matmul", "int4_matmul_tensor_core", "int4_matmul_small_m", "int4_ff",
                "int4_ff_tensor_core", "int4_ff_small_m")}
            triples = dict(zip(("tensor_core", "small_m"), (cfg.num_layers * len(refills), steps)))
            w16 = {k: v // cfg.num_layers * (cfg.num_layers + 1) for k, v in triples.items()}
            # The FF: the refill chunks' on the design ff4._design gives their
            # rows, every decode call's on the small-M design.
            refill_ff = ff4._design(B * PAGED_CHUNK, cfg.features, cfg.hidden,
                                    cfg.quantization_group, torch.bfloat16, mm4._sm_count(0))
            expect = {"int4_matmul3": want, "int4_matmul3_tensor_core": triples["tensor_core"],
                      "int4_matmul3_small_m": triples["small_m"],
                      "int4_matmul": want // cfg.num_layers * (cfg.num_layers + 1),
                      "int4_matmul_tensor_core": w16["tensor_core"],
                      "int4_matmul_small_m": w16["small_m"], "int4_ff": want,
                      "int4_ff_tensor_core": triples["tensor_core"] * (refill_ff == "tensor_core"),
                      "int4_ff_small_m": triples["small_m"]
                      + triples["tensor_core"] * (refill_ff == "small_m")}
            log(f"[engine] {label}: int4 launches {got} (want {expect}: the refill chunks on "
                f"the tensor cores (the FF's on {refill_ff}), every decode call on the small-M "
                f"design)")
            if got != expect:
                raise AssertionError(f"engine {label}: int4 launches {got}, want {expect}")
        for out, p in zip(outs, prompts):
            if out.shape != (len(p) + ENGINE_NEW,) or not np.array_equal(out[: len(p)], p):
                raise AssertionError(f"engine {label}: output {out.shape} is not the prompt "
                                     f"+ {ENGINE_NEW} tokens")
            if out.min() < 0 or out.max() >= cfg.vocab_size:
                raise AssertionError(f"engine {label}: token ids out of range")

    run("unpaged", *engines["unpaged"])
    run("paged", *engines["paged"])
    run("paged+prefix cold", *engines["paged+prefix"], cold=True)
    run("paged+prefix warm", *engines["paged+prefix"])
    run("int4 unpaged", int4_unpaged, q4)
    run("int4+paged+prefix warm", *engines["int4+paged+prefix"])
    del int4_unpaged
    for label, ref in (("paged", "unpaged"), ("paged+prefix cold", "unpaged"),
                       ("paged+prefix warm", "unpaged"),
                       ("int4+paged+prefix warm", "int4 unpaged")):
        same = [np.array_equal(a, b) for a, b in zip(runs[label]["outs"], runs[ref]["outs"])]
        log(f"[engine] {label} tokens equal to {ref}'s: {sum(same)} of {len(same)} requests")
        if not all(same):
            raise AssertionError(f"engine {label}: requests {[i for i, x in enumerate(same) if not x]}"
                                 f" differ from the {ref} engine's")
    for label in ("paged+prefix warm", "int4+paged+prefix warm"):
        st = runs[label]["stats"]
        want_reused = ENGINE_REQUESTS * (ENGINE_SYSTEM // ENGINE_PAGE)
        if st["prefix_hits"] != ENGINE_REQUESTS or st["prefix_pages_reused"] != want_reused:
            raise AssertionError(f"engine {label}: prefix hits {st['prefix_hits']}, pages reused "
                                 f"{st['prefix_pages_reused']}, want {ENGINE_REQUESTS} and "
                                 f"{want_reused}")
    dense = Transformer(dataclasses.replace(cfg, param_dtype=torch.bfloat16), device="cuda",
                        seed=1).eval()
    dense.load_state_dict(params)
    gaps = {label: engine_gap(dense, runs[label]["outs"])
            for label in ("unpaged", "paged", "paged+prefix cold", "paged+prefix warm")}
    dense.load_state_dict(dequantize_tree(q4, torch.bfloat16))
    for label in ("int4 unpaged", "int4+paged+prefix warm"):
        gaps[label] = engine_gap(dense, runs[label]["outs"])
    del dense
    log(f"[engine] teacher-forced max gaps against the dense bf16 forward (int4: on the "
        f"dequantized weights): {gaps} (limit {TF_GAP})")
    bad = {k: v for k, v in gaps.items() if not v <= TF_GAP}
    if bad:
        raise AssertionError(f"engine teacher-forced gaps {bad} > {TF_GAP}")

    latencies = {}

    def call(label, name, cold=False):
        """One timed serve of engine ``name``, keeping its latency stats."""
        serve, tree = engines[name]

        def run_once():
            if cold:
                serve.engine.flush_prefix_cache()
            serve(tree, prompts)
            latencies.setdefault(label, []).append(serve.last_latency)
        return run_once

    int4_cc = "int4+paged+prefix warm, decode on the CUDA cores"
    calls = {label: call(label, name, cold=label.endswith("cold"))
             for label, name in (("unpaged", "unpaged"), ("paged", "paged"),
                                 ("paged+prefix cold", "paged+prefix"),
                                 ("paged+prefix warm", "paged+prefix"),
                                 ("int4+paged+prefix warm", "int4+paged+prefix"))}
    # The int4 engine once more with its decode calls' matmuls (the small-M
    # design's) on the CUDA-core design: what the redesign moved end to end.
    calls[int4_cc] = on_design(call(int4_cc, "int4+paged+prefix"), "cuda_core", only="small_m")
    secs = interleaved_seconds(calls)
    timing = {}
    for label, times in secs.items():
        sec = statistics.median(times)
        lats = latencies[label]
        st = runs[label if label != int4_cc else "int4+paged+prefix warm"]["stats"]
        timing[label] = dict(
            tok_s=ENGINE_REQUESTS * ENGINE_NEW / sec, seconds=times, median_s=sec,
            ttft_p50=statistics.median(x["ttft_p50"] for x in lats),
            refill_frac=statistics.median(x["refill_frac"] for x in lats),
            page_high_water=None if st is None else st["page_high_water"])
        log(f"[time] 125M engine serve, {label} (interleaved): {timing[label]['tok_s']:.1f} "
            f"generated tok/s, {sec:.3f} s per serve (median of 3: "
            f"{[round(t, 4) for t in times]}); TTFT p50 {timing[label]['ttft_p50'] * 1e3:.1f} "
            f"ms, refill {timing[label]['refill_frac']:.3f} of dispatch time (medians over the "
            f"3 serves), page high-water {timing[label]['page_high_water']} on {card}")
    serve, tree = engines["paged+prefix"]
    calls = runs["paged+prefix warm"]["model_forwards"]
    profile = profile_summary(
        f"125M engine serve, paged + prefix warm, per model call ({calls} a serve)",
        lambda: serve(tree, prompts), calls,
        timing["paged+prefix warm"]["median_s"] * 1e3 / calls)
    serve, tree = engines["int4+paged+prefix"]
    calls = runs["int4+paged+prefix warm"]["model_forwards"]
    int4_profiles = {label: profile_summary(
        f"125M engine serve, {label}, per model call ({calls} a serve)", run, calls,
        timing[label]["median_s"] * 1e3 / calls)
        for label, run in (("int4+paged+prefix warm", lambda: serve(tree, prompts)),
                           (int4_cc, on_design(lambda: serve(tree, prompts), "cuda_core",
                                               only="small_m")))}
    summary = {label: dict(stats=r["stats"], launches=r["launches"],
                           model_forwards=r["model_forwards"], latency=r["latency"])
               for label, r in runs.items()}
    del engines
    return dict(runs=summary, teacher_forced_max_gap=gaps, timing=timing, profile=profile,
                int4_profiles=int4_profiles,
                paged_launches=runs["paged+prefix warm"]["launches"]["decode_attention_paged"])


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


def int4_designs(m, k, n, ng, group, dtype, w4a8, nw=1):
    """At a shape: the wrapper's choice as ``(design, tile rows or None,
    splits)``, and each other launch the layout takes, launched directly
    beside it: the CUDA-core design; the tensor-core one (w4a16: at each
    tile); the small-M one unsplit and split (the rule's split, or 3 pieces
    (2 where that is all the layout takes) where the rule keeps one)."""
    sms = mm4._sm_count(0)
    chosen = mm4._variant(m, k, n * nw, ng, group, dtype, w4a8, sms)
    tiles = [None] if w4a8 else [mm4.TILE_ROWS, mm4.SMALL_TILE_ROWS]
    rule_tile = mm4._tile_rows(m, n, nw, sms) if chosen == "tensor_core" and not w4a8 else None
    every = [("cuda_core", None, 1)]
    if mm4._tensor_core_layout(k, ng, group, dtype, w4a8):
        every += [("tensor_core", t, 1) for t in tiles]
    rule_splits = 1
    if mm4._small_m_layout(k, ng, group, dtype, w4a8):
        rule_splits = mm4._splits(m, k, n, nw, ng, group, sms, w4a8)
        choices = mm4.split_choices(k // 2, ng, group, w4a8)
        split = rule_splits if rule_splits > 1 else choices[min(2, len(choices) - 1)]
        every += [("small_m", None, 1)] + ([("small_m", None, split)] if split > 1 else [])
    rule = (chosen, rule_tile, rule_splits if chosen == "small_m" else 1)
    return rule, [d for d in every if d != rule]


def design_name(design, tile=None, splits=1):
    if tile:
        return f"{design} {tile}-row"
    return f"{design} split" if splits > 1 else design


def counted(kernel, chosen, call):
    """``call()`` through a wrapper, asserting that it counted one launch of
    ``kernel`` and, beside it, one launch of the design the wrapper's rule
    chose (none for the CUDA-core design)."""
    def counts():
        if kernel == "int4_matmul3":
            return (mm4.int4_matmul3.launches, mm4.int4_matmul3.tensor_core_launches,
                    mm4.int4_matmul3.small_m_launches)
        key = "w4a8" if kernel == "int4_matmul_w4a8" else "w4a16"
        launches = mm4.int4_matmul.launches
        return launches[key], launches[f"{key}_tensor_core"], launches[f"{key}_small_m"]

    before = counts()
    out = call()
    want = (before[0] + 1, before[1] + (chosen == "tensor_core"),
            before[2] + (chosen == "small_m"))
    if counts() != want:
        raise AssertionError(f"{kernel} ({chosen}) counted {counts()}, want {want}")
    return out


def ff_designs(m, group, dtype, k=768, hidden=3072):
    """The FF at a shape: the wrapper's choice as ``(design, up tile rows,
    down splits)`` (both None but for the tensor-core design), and each
    other launch the shape takes: every design whose layout holds, the
    tensor-core one at each split of its down launch and at the other tile
    of its up launch (128 or 96 rows)."""
    sms = mm4._sm_count(0)
    chosen = ff4._design(m, k, hidden, group, dtype, sms)
    every = [("cuda_core", None, None)]
    if dtype == torch.bfloat16 and ff4._tensor_core_layout(k, hidden, group):
        up = mm4._tile_rows(m, hidden, 1, sms)
        split = ff4._down_splits(m, k, hidden, group, sms)
        other = mm4.SMALL_TILE_ROWS if up == mm4.TILE_ROWS else mm4.TILE_ROWS
        every += [("tensor_core", up, s) for s in ff4.down_split_choices(k, hidden, group)]
        every.append(("tensor_core", other, split))
    if (dtype == torch.bfloat16 and m <= mm4.SMALL_M_ROWS
            and ff4._small_m_layout(k, hidden, group)):
        every.append(("small_m", None, None))
    rule = (chosen, None, None)
    if chosen == "tensor_core":
        rule = (chosen, mm4._tile_rows(m, hidden, 1, sms), ff4._down_splits(m, k, hidden, group,
                                                                           sms))
    return rule, [d for d in every if d != rule]


def ff_design_name(design, up=None, splits=None):
    return f"{design} {up}-row/{splits} pieces" if up else design


def counted_ff(chosen, call):
    """``call()`` through ``int4_ff``, asserting that it counted one launch
    and, beside it, one of the design ``ff4._design`` chose (none for the
    CUDA-core design)."""
    def counts():
        f = ff4.int4_ff
        return f.launches, f.tensor_core_launches, f.small_m_launches

    before = counts()
    out = call()
    want = (before[0] + 1, before[1] + (chosen == "tensor_core"),
            before[2] + (chosen == "small_m"))
    if counts() != want:
        raise AssertionError(f"int4_ff ({chosen}) counted {counts()}, want {want}")
    return out


def check_int4(gen):
    """The four int4 kernels against their plain versions. w4a16, the q/k/v
    triple and w4a8 in fp32 and bf16 activations at every
    ``INT4_CHECK_SITES`` site, ``INT4_CHECK_ROWS`` row count and
    ``INT4_CHECK_GROUPS`` layout: through the public wrappers
    (``int4_matmul``, ``int4_matmul3``, ``int4_matmul(w4a8=True)``), whose
    counts must move as ``_variant`` says, and each other design (and
    tile, and split) the layout takes launched directly; every small-M
    launch twice, bit-equal; the FF at its decode and prefill shapes, an
    odd M, a whole-K/H group and group 64 through ``int4_ff`` (whose
    counts must move as ``ff4._design`` says) and each other design that
    takes the shape, every launch twice, bit-equal → per kernel and dtype the
    largest relative (checked) and absolute error over every design, per
    design the same, and w4a8's count of outputs that are not bit-equal."""
    worst, by_design = {}, {}
    unequal = {"w4a8 outputs": 0, "not bit-equal": 0, "small_m relaunches": 0,
               "int4_ff relaunches": 0}

    def again(design, first, launch):
        """A small-M launch once more: its bits must not move."""
        if design[0] != "small_m":
            return
        unequal["small_m relaunches"] += 1
        second = launch()
        for a, b in zip(first if isinstance(first, (list, tuple)) else [first],
                        second if isinstance(second, (list, tuple)) else [second]):
            if not torch.equal(a, b):
                raise AssertionError(f"small_m {design}: a second launch gave other bits")
    ff_cases = [("ff decode", B, 128), ("ff prefill", 1024, 128), ("ff m37", 37, 128),
                ("ff whole-K/H group", B, 4096), ("ff group 64", B, 64)]

    def note(kernel, design, dtype, name, errs, tol):
        if not errs[0] <= tol:
            raise AssertionError(f"{kernel} {design} {name} {dtype}: relative error {errs[0]} "
                                 f"> {tol}")
        if dtype == torch.bfloat16 and not errs[2] <= INT4_BF16_FLIPS:
            raise AssertionError(f"{kernel} {design} {name}: {errs[2]} of bf16 outputs differ "
                                 f"from the plain version's > {INT4_BF16_FLIPS}")
        for table, key in ((worst, (kernel, dtype)), (by_design, (kernel, design, dtype))):
            old = table.get(key, (0.0, 0.0, 0.0, 0))
            table[key] = (max(old[0], errs[0]), max(old[1], errs[1]), max(old[2], errs[2]),
                          old[3] + 1)

    for site, (k, n) in INT4_CHECK_SITES.items():
        for g in INT4_CHECK_GROUPS:
            group = g or k
            nodes = [int4_weight(gen, k, n, group) for _ in range(3)]
            pairs = [(nd["q4"], nd["scale"]) for nd in nodes]
            ng = pairs[0][1].shape[0]
            for m in INT4_CHECK_ROWS:
                name = f"{site} m={m} group {g or 'whole-K'}"
                for dtype in (torch.float32, torch.bfloat16):
                    tol = INT4_TOL[dtype]
                    x = randn(gen, m, k, dtype=dtype)
                    wants = [mm4.int4_matmul_reference(x, *pair, group=group) for pair in pairs]
                    for kernel, nw, wrapper in (
                            ("int4_matmul", 1,
                             lambda: [mm4.int4_matmul(x, *pairs[0], group=group)]),
                            ("int4_matmul3", 3, lambda: mm4.int4_matmul3(x, pairs, group=group))):
                        chosen, others = int4_designs(m, k, n, ng, group, dtype, False, nw)
                        launched = [(chosen, counted(kernel, chosen[0], wrapper), wrapper)]
                        for design in others:
                            def launch(design=design):
                                return mm4._launch_w4a16(
                                    x, pairs[:nw], group=group, variant=design[0],
                                    tile_rows=design[1], splits=design[2])
                            launched.append((design, launch(), launch))
                        for design, outs, launch in launched:
                            again(design, outs, launch)
                            errs = [rel_err(name, o, w) for o, w in zip(outs, wants)]
                            note(kernel, design_name(*design), dtype, name,
                                 tuple(map(max, zip(*errs))), tol)
                    xq, sx = mm4.quantize_rows_int8(x)
                    want = mm4.int4_matmul_w4a8_reference(xq, sx, *pairs[0], group=group,
                                                          out_dtype=dtype)
                    chosen, others = int4_designs(m, k, n, ng, group, dtype, True)

                    def public():
                        return mm4.int4_matmul(x, *pairs[0], group=group, w4a8=True)
                    launched = [(chosen, counted("int4_matmul_w4a8", chosen[0], public), public)]
                    for design in others:
                        def launch(design=design):
                            return mm4._launch_w4a8(xq, sx, *pairs[0], group=group,
                                                    out_dtype=dtype, variant=design[0],
                                                    splits=design[2])
                        launched.append((design, launch(), launch))
                    for design, got, launch in launched:
                        again(design, got, launch)
                        differ = int((got != want).sum().item())
                        if differ and design[0] == "small_m":
                            raise AssertionError(f"w4a8 {design} {name} {dtype}: {differ} "
                                                 f"outputs not bit-equal to the plain version's")
                        unequal["w4a8 outputs"] += got.numel()
                        unequal["not bit-equal"] += differ
                        note("int4_matmul_w4a8", design_name(*design), dtype, name,
                             rel_err(name, got, want),
                             W4A8_TOL if dtype == torch.float32 else tol)
    for dtype in (torch.float32, torch.bfloat16):
        for name, m, g in ff_cases:
            up, dn = int4_weight(gen, 768, 3072, g), int4_weight(gen, 3072, 768, g)
            x = randn(gen, m, 768, dtype=dtype)
            args = (up["q4"], up["scale"], dn["q4"], dn["scale"])
            want = ff4.int4_ff_reference(x, *args, group=g)
            chosen, others = ff_designs(m, g, dtype)

            def public():
                return ff4.int4_ff(x, *args, group=g)
            launched = [(chosen, counted_ff(chosen[0], public), public)]
            for design in others:
                def launch(design=design):
                    return ff4._launch_cuda(x, *args, group=g, design=design[0],
                                            up_rows=design[1], down_splits=design[2])[0]
                launched.append((design, launch(), launch))
            for design, got, launch in launched:
                unequal["int4_ff relaunches"] += 1
                if not torch.equal(got, launch()):
                    raise AssertionError(f"int4_ff {design} {name}: a second launch gave "
                                         f"other bits")
                note("int4_ff", ff_design_name(*design), dtype, name, rel_err(name, got, want),
                     INT4_TOL[dtype])
    torch.cuda.synchronize()
    for (kernel, design, dtype), (rel, abs_err, flips, cases) in sorted(
            by_design.items(), key=lambda kv: (kv[0][0], kv[0][1], str(kv[0][2]))):
        log(f"[int4] {kernel} {design} {str(dtype)[6:]}: {cases} cases, max err {rel:.3e} of "
            f"the largest |ref| (abs {abs_err:.3e}, tol "
            f"{W4A8_TOL if kernel.endswith('w4a8') and dtype == torch.float32 else INT4_TOL[dtype]:.3g}), "
            f"at most {flips:.2e} of outputs differ")
    log(f"[int4] w4a8: {unequal['not bit-equal']} of {unequal['w4a8 outputs']} outputs not "
        f"bit-equal to the plain version's (every design and split, fp32 and bf16)")
    log(f"[int4] every w4a16, triple and w4a8 case ran through its public wrapper, whose "
        f"launch and design counts moved as _variant says; {unequal['small_m relaunches']} "
        f"small-M launches repeated bit-equal; every FF case through int4_ff (counts as "
        f"ff4._design says) and each other design, {unequal['int4_ff relaunches']} FF "
        f"launches repeated bit-equal")
    return worst, by_design, unequal


INT4_KERNELS = ("int4_matmul", "int4_matmul_w4a8", "int4_matmul3", "int4_ff")


def reset_launches() -> None:
    decode_attention.launches = 0
    decode_attention.paged_launches = 0
    decode_attention.tensor_core_launches = 0
    decode_attention.split_launches = 0
    mm4.int4_matmul.launches = dict.fromkeys(mm4.int4_matmul.launches, 0)
    mm4.int4_matmul3.launches = 0
    mm4.int4_matmul3.tensor_core_launches = 0
    mm4.int4_matmul3.small_m_launches = 0
    ff4.int4_ff.launches = 0
    ff4.int4_ff.small_m_launches = 0
    ff4.int4_ff.tensor_core_launches = 0


def read_launches() -> dict:
    """Each kernel's launches (every design of the int4 matmuls and the
    FF), and the tensor-core and small-M designs' among them."""
    return {"int4_matmul": mm4.int4_matmul.launches["w4a16"],
            "int4_matmul_w4a8": mm4.int4_matmul.launches["w4a8"],
            "int4_matmul3": mm4.int4_matmul3.launches, "int4_ff": ff4.int4_ff.launches,
            "decode_attention": decode_attention.launches,
            "decode_attention_paged": decode_attention.paged_launches,
            "decode_attention_tensor_core": decode_attention.tensor_core_launches,
            "decode_attention_split": decode_attention.split_launches,
            "int4_matmul_tensor_core": mm4.int4_matmul.launches["w4a16_tensor_core"],
            "int4_matmul_w4a8_tensor_core": mm4.int4_matmul.launches["w4a8_tensor_core"],
            "int4_matmul3_tensor_core": mm4.int4_matmul3.tensor_core_launches,
            "int4_matmul_small_m": mm4.int4_matmul.launches["w4a16_small_m"],
            "int4_matmul_w4a8_small_m": mm4.int4_matmul.launches["w4a8_small_m"],
            "int4_matmul3_small_m": mm4.int4_matmul3.small_m_launches,
            "int4_ff_small_m": ff4.int4_ff.small_m_launches,
            "int4_ff_tensor_core": ff4.int4_ff.tensor_core_launches}


def want_generate_launches(cfg, mode, b=B, prompt=PROMPT, new=NEW) -> dict:
    """Every counter of ``read_launches`` after one rectangular generate
    (b, prompt, +new) with ``dequantize=mode`` (False and True run no int4
    kernel): one prefill (M = b × prompt rows) and new - 1 decode steps
    (M = b); the prefill's int4 matmuls and FFs take the tensor-core
    design, every decode step's the small-M design (ops/int4_matmul.py::
    _variant, ops/int4_ff.py::_design); decode attention as in the bf16
    generate (generate_decode_launches)."""
    layers, steps = cfg.num_layers, new - 1
    none = {"int4_matmul": 0, "int4_matmul_w4a8": 0, "int4_matmul3": 0, "int4_ff": 0,
            "int4_matmul_tensor_core": 0, "int4_matmul_w4a8_tensor_core": 0,
            "int4_matmul3_tensor_core": 0, "int4_matmul_small_m": 0,
            "int4_matmul_w4a8_small_m": 0, "int4_matmul3_small_m": 0, "int4_ff_small_m": 0,
            "int4_ff_tensor_core": 0, "decode_attention": layers * new,
            "decode_attention_paged": 0, **generate_decode_launches(cfg, b, prompt, new)}
    if mode == "fused":
        return {**none, "int4_matmul": (layers + 1) * new, "int4_matmul3": layers * new,
                "int4_ff": layers * new, "int4_matmul_tensor_core": layers + 1,
                "int4_matmul3_tensor_core": layers, "int4_matmul_small_m": (layers + 1) * steps,
                "int4_matmul3_small_m": layers * steps, "int4_ff_tensor_core": layers,
                "int4_ff_small_m": layers * steps}
    if mode == "fused_w4a8":
        return {**none, "int4_matmul_w4a8": (6 * layers + 1) * new,
                "int4_matmul_w4a8_tensor_core": 6 * layers + 1,
                "int4_matmul_w4a8_small_m": (6 * layers + 1) * steps}
    return none


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
    want = {mode: want_generate_launches(cfg, mode) for mode in ("fused", "fused_w4a8")}
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


def on_design(fn, design, module=mm4, rule="_variant", only=None):
    """``fn`` with every kernel that ``module.rule`` routes (only those it
    routes to ``only``, when given) launched on one design (the int4
    matmuls by default; ``flash, "_bwd_design"`` or ``"_fwd_design"`` the
    flash backward or forward): the wrapper's rule is patched for the call
    (a yardstick; the port never does this)."""
    def call():
        chosen = getattr(module, rule)

        def patched(*args):
            return design if only is None or chosen(*args) == only else chosen(*args)
        setattr(module, rule, patched)
        try:
            return fn()
        finally:
            setattr(module, rule, chosen)
    return call


def time_int4_decode(q4, prompt, card, fns):
    """The int4-fused and int4-w4a8 generates (b=8, prompt 128, +128), host
    clock around a synchronised call, medians of 3 interleaved, beside the
    same calls with every matmul that the rule gives the small-M design
    (the decode steps') launched on the CUDA-core design instead, and the
    int4-fused generate with every ``int4_ff`` on its CUDA-core design;
    then each of the five profiled: device-busy ms per token step and the
    int4 matmuls' and ``int4_ff``'s ms per step (their kernels' profiled
    time over NEW steps)."""
    calls = {}
    for mode, name in (("fused", "int4-fused"), ("fused_w4a8", "int4-w4a8")):
        run = functools.partial(fns[mode], q4, prompt)
        calls[name] = run
        calls[f"{name}, decode on the CUDA cores"] = on_design(run, "cuda_core", only="small_m")
    calls["int4-fused, int4_ff on the CUDA cores"] = on_design(
        calls["int4-fused"], "cuda_core", module=ff4, rule="_design")
    times = interleaved_seconds(calls)
    rows = {}
    for name, run in calls.items():
        sec = statistics.median(times[name])
        ms = sec / NEW * 1e3
        prof = profile_summary(f"125M {name} generate token step", run, NEW, ms)
        int4_ms = sum(v for kernel, v in prof["port_kernels_ms_per_step"].items()
                      if kernel.startswith("int4_matmul"))
        ff_ms = sum(v for kernel, v in prof["port_kernels_ms_per_step"].items()
                    if kernel.startswith("int4_ff"))
        rows[name] = dict(tok_s=B * NEW / sec, ms_per_token_step=ms, seconds=times[name],
                          int4_matmul_ms_per_step=int4_ms, int4_ff_ms_per_step=ff_ms,
                          profile=prof)
        log(f"[time] 125M {name} generate b={B} prompt {PROMPT} +{NEW} (interleaved): "
            f"{B * NEW / sec:.1f} tok/s, {ms:.3f} ms/token-step (median of 3: "
            f"{[round(t, 4) for t in times[name]]} s); profiled: device busy "
            f"{prof['busy_ms_per_step']:.3f} ms a step, int4 matmuls {int4_ms:.4f} ms and "
            f"int4_ff {ff_ms:.4f} ms a step on {card}")
    return rows


def time_int4_prefill(q4, prompt, card):
    """The int4 generate's prefill call alone (b=8, prompt 128: the decode
    model's cached apply from an empty cache, full-width lm_head and fp32
    logits, as ``make_generate_fn`` runs it) under ``"fused"`` and
    ``"fused_w4a8"``, host clock around a synchronised call, medians of 3
    interleaved; beside each, the same call with every int4 matmul forced
    onto the CUDA-core design (``_variant`` patched for the yardstick only)
    and, for ``"fused"``, the same call with only ``int4_ff`` on its
    CUDA-core design (``ff4._design`` patched), the launches of one prefill
    with each kernel's tensor-core share, and a profile of each call
    (device busy against the host clock)."""
    prefills, launches = {}, {}
    for mode in ("fused", "fused_w4a8"):
        cfg, _ = apply_dequantize_policy(derive_decode_config(CONFIG_125M, torch.bfloat16), mode)
        model = Transformer(cfg, device="cuda").eval()
        model.load_state_dict(make_param_caster(torch.bfloat16, "cuda", dequantize=True)(q4))
        apply = make_cached_apply(model)
        prefills[mode] = functools.partial(torch.no_grad()(apply), None, prompt)
        torch.cuda.synchronize()
        reset_launches()
        prefills[mode]()
        torch.cuda.synchronize()
        launches[mode] = {k: v for k, v in read_launches().items() if v}
    cuda_core = {f"{mode} cuda-core": on_design(fn, "cuda_core") for mode, fn in prefills.items()}
    # The same "fused" call with only int4_ff on its CUDA-core design.
    ff_cc = on_design(prefills["fused"], "cuda_core", module=ff4, rule="_design")
    times = interleaved_seconds({**prefills, **cuda_core, "fused ff cuda-core": ff_cc})
    rows = {}
    for mode in prefills:
        ms = statistics.median(times[mode]) * 1e3
        cc_ms = statistics.median(times[f"{mode} cuda-core"]) * 1e3
        log(f"[time] 125M int4 prefill dequantize={mode!r} b={B} prompt {PROMPT}: {ms:.3f} ms "
            f"(int4 matmuls by the wrapper's rule: launches {launches[mode]}); all on the "
            f"CUDA-core design {cc_ms:.3f} ms ({cc_ms / ms:.2f}x; calls "
            f"{[round(t * 1e3, 3) for t in times[mode]]} / "
            f"{[round(t * 1e3, 3) for t in times[f'{mode} cuda-core']]} ms) on {card}")
        rows[mode] = dict(
            ms=ms, cuda_core_ms=cc_ms, seconds=times[mode],
            cuda_core_seconds=times[f"{mode} cuda-core"], launches=launches[mode],
            profile=profile_summary(f"125M int4 prefill {mode}", prefills[mode], 1, ms),
            cuda_core_profile=profile_summary(f"125M int4 prefill {mode}, all on the CUDA-core "
                                              f"design", cuda_core[f"{mode} cuda-core"], 1, cc_ms))
    ff_ms = statistics.median(times["fused ff cuda-core"]) * 1e3
    log(f"[time] 125M int4 prefill dequantize='fused' with int4_ff on its CUDA-core design "
        f"(the matmuls by their rule): {ff_ms:.3f} ms against {rows['fused']['ms']:.3f} "
        f"({ff_ms / rows['fused']['ms']:.2f}x; calls "
        f"{[round(t * 1e3, 3) for t in times['fused ff cuda-core']]} ms) on {card}")
    rows["fused"].update(
        ff_cuda_core_ms=ff_ms, ff_cuda_core_seconds=times["fused ff cuda-core"],
        ff_cuda_core_profile=profile_summary("125M int4 prefill fused, int4_ff on the CUDA-core "
                                             "design", ff_cc, 1, ff_ms))
    return rows


def time_int4(gen, card):
    """Each int4 kernel at its 125M sites, bf16: w4a16 and w4a8 at every
    site and the q/k/v triple, at ``INT4_TIME_ROWS`` rows; the FF at decode
    and prefill (``time_ff``). Each matmul row times every design on the same inputs,
    launched directly: the small-M one (at the rule's split), the
    tensor-core one (w4a16 and the triple: with 128- and with 96-row tiles)
    and the CUDA-core one; ``ms`` is the one the wrapper's rule takes.
    Beside them the plain version, the library yardstick (``torch.matmul``
    of x with the weight dequantized to bf16 beforehand; the FF: two of them
    and a GELU) and the bound (w4a8's operations at the int8 peak, 1979
    TOP/s). At decode rows (M = B) each design and the yardstick also run
    HBM-cold: every call reads its own copy of the weights, the copies past
    the L2 (``cold_time``)."""
    bf16 = torch.bfloat16
    rows = {}
    sms = mm4._sm_count(0)

    def record(kernel, site, m, launch, plain, library, nbytes, ops, peak, variant=None,
               tile=None, splits=None, cold=None, split_layout=None):
        """``launch(design, tile, weights, splits)`` launches one design on
        the given weights (None: the row's own) and split (None: the rule's);
        the FF has one design. ``variant``, ``tile`` and ``splits`` are the
        wrapper's choice. ``cold``: (int4 weight copies, the yardstick's call
        on a copy index, its copies); given at decode rows, where the
        small-M design is also timed at every split it takes."""
        if not variant:
            designs = [(None, None)]
        elif kernel == "int4_matmul_w4a8":
            designs = [("small_m", None), ("tensor_core", None), ("cuda_core", None)]
        else:
            designs = [("small_m", None), ("tensor_core", mm4.TILE_ROWS),
                       ("tensor_core", mm4.SMALL_TILE_ROWS), ("cuda_core", None)]
        times, late = {}, 0
        for design in designs:
            times[design], n_late = queued_time(launch, *design, None, None)
            late += n_late
        sweep = {}
        if cold and variant == "small_m":
            for sp in mm4.split_choices(*split_layout):
                if sp <= mm4.MAX_SMALL_M_SPLITS:
                    sweep[sp], n_late = queued_time(launch, "small_m", None, None, sp)
                    late += n_late
        plain_ms, plain_late = queued_time(plain, inner=3, repeats=5)
        lib_ms, lib_late = queued_time(library)
        bound_ms, by = bound(nbytes, ops, peak)
        tc_tile = tile if kernel != "int4_matmul_w4a8" else None
        chosen = (variant, tc_tile if variant == "tensor_core" else None)
        row = dict(ms=times[chosen] * 1e3, plain_ms=plain_ms * 1e3, yardstick_ms=lib_ms * 1e3,
                   bound_ms=bound_ms, bound_by=by, bytes=nbytes, ops=ops,
                   late_samples=late + plain_late + lib_late)
        if variant:
            row.update(variant=variant, small_m_ms=times["small_m", None] * 1e3,
                       small_m_splits=splits, tensor_core_ms=times["tensor_core", tc_tile] * 1e3,
                       cuda_core_ms=times["cuda_core", None] * 1e3)
            if sweep:
                row["small_m_split_sweep_ms"] = {str(k): v * 1e3 for k, v in sweep.items()}
            if tc_tile:
                row.update(tile_rows=tile, tile_ms={str(t): times["tensor_core", t] * 1e3
                                                    for _, t in designs if t})
        if cold:
            copies, lib_call, lib_copies = cold
            secs = {design_name(*d): cold_time([functools.partial(launch, *d, w, None)
                                                for w in copies])
                    for d in designs}
            lib_cold = cold_time([functools.partial(lib_call, i) for i in range(lib_copies)])
            row["hbm_cold"] = dict(
                {name: v[0] * 1e3 for name, v in secs.items()}, yardstick_ms=lib_cold[0] * 1e3,
                copies=len(copies), yardstick_copies=lib_copies,
                late_samples=sum(v[1] for v in secs.values()) + lib_cold[1])
        rows.setdefault(kernel, {})[f"{site} m={m}"] = row
        tiles = (" (" + ", ".join(f"{t}-row tiles {ms * 1e3:.2f} us" for t, ms in
                                  row["tile_ms"].items()) + ")"
                 if variant and tc_tile else "")
        designs_us = (f"small-M {row['small_m_ms'] * 1e3:.2f} us ({splits} pieces), tensor-core "
                      f"{row['tensor_core_ms'] * 1e3:.2f} us{tiles}, CUDA-core "
                      f"{row['cuda_core_ms'] * 1e3:.2f} us (the wrapper takes {variant}; CUDA-core "
                      f"over small-M {row['cuda_core_ms'] / row['small_m_ms']:.2f}x)" if variant
                      else f"kernel {row['ms'] * 1e3:.2f} us")
        cold_us = ("; HBM-cold " + ", ".join(
            f"{k} {v * 1e3:.2f}" for k, v in row["hbm_cold"].items() if k.endswith("ms")
            or k in (design_name(*d) for d in designs)) + " us" if cold else "")
        sweep_us = ("; small-M by pieces " + ", ".join(
            f"{k}: {v * 1e3:.2f}" for k, v in row["small_m_split_sweep_ms"].items()) + " us"
            if sweep else "")
        log(f"[time] {kernel} {site} m={m} bf16: {designs_us}, bound {bound_ms * 1e3:.2f} us "
            f"({by}), plain {row['plain_ms'] * 1e3:.2f} us, bf16 dense yardstick "
            f"{row['yardstick_ms'] * 1e3:.2f} us{cold_us}{sweep_us}"
            + (f" ({row['late_samples']} samples enqueued past the sleep)" if row["late_samples"] else ""))

    int8_peak = 1979e12
    for site, (k, n) in INT4_SITES.items():
        node = int4_weight(gen, k, n, 128)
        q4, s = node["q4"], node["scale"]
        ng = s.shape[0]
        w = dequantize_leaf_int4(node, bf16)
        wbytes = q4.numel() + s.numel() * 4
        copies = [(q4.clone(), s.clone()) for _ in range(copies_past_l2(wbytes))]
        w_copies = [w.clone() for _ in range(copies_past_l2(w.numel() * 2))]
        for m in INT4_TIME_ROWS:
            x = randn(gen, m, k, dtype=bf16)
            xq, sx = mm4.quantize_rows_int8(x)
            cold = (copies, lambda i: torch.matmul(x, w_copies[i]), len(w_copies)) if m == B else None
            record("int4_matmul", site, m,
                   lambda d, t, ws, sp: mm4._launch_w4a16(x, [ws or (q4, s)], group=128,
                                                          variant=d, tile_rows=t, splits=sp),
                   lambda: mm4.int4_matmul_reference(x, q4, s, group=128),
                   lambda: torch.matmul(x, w),
                   2 * m * k + wbytes + 2 * m * n, 2 * m * k * n, None,
                   mm4._variant(m, k, n, ng, 128, bf16, False, sms), mm4._tile_rows(m, n, 1, sms),
                   mm4._splits(m, k, n, 1, ng, 128, sms), cold, (k // 2, ng, 128, False))
            record("int4_matmul_w4a8", site, m,
                   lambda d, _, ws, sp: mm4._launch_w4a8(xq, sx, *(ws or (q4, s)), group=128,
                                                         out_dtype=bf16, variant=d, splits=sp),
                   lambda: mm4.int4_matmul_w4a8_reference(xq, sx, q4, s, group=128,
                                                          out_dtype=bf16),
                   lambda: torch.matmul(x, w),
                   m * k + 4 * m + wbytes + 2 * m * n, 2 * m * k * n, int8_peak,
                   mm4._variant(m, k, n, ng, 128, bf16, True, sms), None,
                   mm4._splits(m, k, n, 1, ng, 128, sms, True), cold, (k // 2, ng, 128, True))
        del node, q4, s, w, copies, w_copies
        torch.cuda.empty_cache()
    nodes = [int4_weight(gen, 768, 768, 128) for _ in range(3)]
    pairs = [(nd["q4"], nd["scale"]) for nd in nodes]
    w_qkv = torch.cat([dequantize_leaf_int4(nd, bf16) for nd in nodes], dim=1)
    wbytes = sum(q.numel() + sc.numel() * 4 for q, sc in pairs)
    copies = [[(q.clone(), sc.clone()) for q, sc in pairs] for _ in range(copies_past_l2(wbytes))]
    w_copies = [w_qkv.clone() for _ in range(copies_past_l2(w_qkv.numel() * 2))]
    for m in INT4_TIME_ROWS:
        x = randn(gen, m, 768, dtype=bf16)
        cold = (copies, lambda i: torch.matmul(x, w_copies[i]), len(w_copies)) if m == B else None
        record("int4_matmul3", "qkv", m,
               lambda d, t, ws, sp: mm4._launch_w4a16(x, ws or pairs, group=128, variant=d,
                                                      tile_rows=t, splits=sp),
               lambda: [mm4.int4_matmul_reference(x, *p, group=128) for p in pairs],
               lambda: torch.matmul(x, w_qkv),
               2 * m * 768 + wbytes + 3 * 2 * m * 768, 3 * 2 * m * 768 * 768, None,
               mm4._variant(m, 768, 3 * 768, pairs[0][1].shape[0], 128, bf16, False, sms),
               mm4._tile_rows(m, 768, 3, sms),
               mm4._splits(m, 768, 768, 3, pairs[0][1].shape[0], 128, sms), cold,
               (384, pairs[0][1].shape[0], 128, False))
    del copies, w_copies
    torch.cuda.empty_cache()
    rows["int4_ff"] = time_ff(gen, card)
    log(f"[time] int4 kernels measured on {card}")
    return rows


def time_ff(gen, card, k=768, hidden=3072, group=128):
    """``int4_ff`` at the 125M FF (768 → 3072 → 768, group 128), bf16, at
    every ``INT4_TIME_ROWS`` row count, queued: each design on the same
    inputs (small-M up to ``SMALL_M_ROWS`` rows; the tensor-core one at the
    rule's tiles and split, and at every other split of its down launch and
    the other up tile; the CUDA-core one), beside the bound (the weights'
    bytes or the 4·M·K·H products at the bf16 peak), the tensor-core
    design's own floor ((2 + 6)·M·K·H: three MMAs a down tile), the plain
    version, the dense bf16 FF (two ``torch.matmul`` on the weights
    dequantized to bf16 beforehand and a GELU) and the per-projection int4
    path on the same weights (two ``int4_matmul`` launches and a GELU). At
    decode rows (M = B) each design and both yardsticks also run HBM-cold
    (``cold_time``)."""
    bf16 = torch.bfloat16
    sms = mm4._sm_count(0)
    gelu = torch.nn.functional.gelu
    up, dn = int4_weight(gen, k, hidden, group), int4_weight(gen, hidden, k, group)
    args = (up["q4"], up["scale"], dn["q4"], dn["scale"])
    w1, w2 = dequantize_leaf_int4(up, bf16), dequantize_leaf_int4(dn, bf16)
    wbytes = sum(t.numel() * t.element_size() for t in args)
    copies = [tuple(t.clone() for t in args) for _ in range(copies_past_l2(wbytes))]
    w_copies = [(w1.clone(), w2.clone())
                for _ in range(copies_past_l2((w1.numel() + w2.numel()) * 2))]
    rows = {}
    for m in INT4_TIME_ROWS:
        x = randn(gen, m, k, dtype=bf16)
        rule, others = ff_designs(m, group, bf16, k, hidden)

        def launch(design, ws=None):
            return ff4._launch_cuda(x, *(ws or args), group=group, design=design[0],
                                    up_rows=design[1], down_splits=design[2])

        def dense(w=(w1, w2)):
            return torch.matmul(gelu(torch.matmul(x, w[0]), approximate="tanh"), w[1])

        def per_projection(ws=args):
            h = gelu(mm4.int4_matmul(x, ws[0], ws[1], group=group), approximate="tanh")
            return mm4.int4_matmul(h, ws[2], ws[3], group=group)

        late, times = 0, {}
        for design in [rule, *others]:
            times[design], n_late = queued_time(launch, design)
            late += n_late
        plain_ms, n_plain = queued_time(ff4.int4_ff_reference, x, *args, group=group, inner=3,
                                        repeats=5)
        dense_ms, n_dense = queued_time(dense)
        proj_ms, n_proj = queued_time(per_projection)
        late += n_plain + n_dense + n_proj
        nbytes, ops = 2 * m * k + wbytes + 2 * m * k, 4 * m * k * hidden
        bound_ms, by = bound(nbytes, ops)
        tc = [d for d in times if d[0] == "tensor_core"]
        tc_rule = rule if rule[0] == "tensor_core" else (
            "tensor_core", mm4._tile_rows(m, hidden, 1, sms),
            ff4._down_splits(m, k, hidden, group, sms))
        row = dict(design=rule[0], ms=times[rule] * 1e3, plain_ms=plain_ms * 1e3,
                   yardstick_ms=dense_ms * 1e3, per_projection_ms=proj_ms * 1e3,
                   bound_ms=bound_ms, bound_by=by, bytes=nbytes, ops=ops,
                   design_floor_ms=8 * m * k * hidden / (device_peak_flops() or 989e12) * 1e3,
                   cuda_core_ms=times["cuda_core", None, None] * 1e3,
                   tensor_core_ms=times[tc_rule] * 1e3, tensor_core_tiles=list(tc_rule[1:]),
                   tensor_core_sweep_ms={f"{d[1]}-row/{d[2]}": times[d] * 1e3 for d in tc},
                   late_samples=late)
        if ("small_m", None, None) in times:
            row["small_m_ms"] = times["small_m", None, None] * 1e3
        if m == B:
            cold = {ff_design_name(*d): cold_time([functools.partial(launch, d, ws)
                                                   for ws in copies])
                    for d in times if d[0] != "tensor_core" or d == tc_rule}
            cold["dense bf16 FF"] = cold_time([functools.partial(dense, w) for w in w_copies])
            cold["per-projection int4"] = cold_time([functools.partial(per_projection, ws)
                                                     for ws in copies])
            row["hbm_cold"] = dict({name: v[0] * 1e3 for name, v in cold.items()},
                                   copies=len(copies), yardstick_copies=len(w_copies),
                                   late_samples=sum(v[1] for v in cold.values()))
        rows[f"ff m={m}"] = row
        designs_us = ", ".join(
            f"{name} {row[key] * 1e3:.2f} us" for name, key in (
                ("small-M", "small_m_ms"), ("tensor-core", "tensor_core_ms"),
                ("CUDA-core", "cuda_core_ms")) if key in row)
        cold_us = ("; HBM-cold " + ", ".join(f"{name} {v * 1e3:.2f}" for name, v in
                                             row["hbm_cold"].items() if isinstance(v, float))
                   + " us" if m == B else "")
        log(f"[time] int4_ff ff m={m} bf16: {designs_us} (the wrapper takes {rule[0]}; "
            f"tensor-core at {tc_rule[1]}-row up tiles, {tc_rule[2]} down pieces; sweep "
            + ", ".join(f"{key}: {v * 1e3:.2f}" for key, v in row["tensor_core_sweep_ms"].items())
            + f" us), bound {bound_ms * 1e3:.2f} us ({by}), tensor-core floor "
            f"{row['design_floor_ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f} us, dense "
            f"bf16 FF {row['yardstick_ms'] * 1e3:.2f} us, per-projection int4 "
            f"{row['per_projection_ms'] * 1e3:.2f} us{cold_us} on {card}"
            + (f" ({late} samples enqueued past the sleep)" if late else ""))
    return rows


def check_probes(gen):
    """[probes] Each probe kernel against its plain version at the probe
    scripts' shapes: the (8, 128) copy bit-equal; the (8, 2048) x (2048,
    8192) matmul in one call and in four calls of 2048 columns within
    ``PROBE_TOL`` of the largest |ref| with at most ``INT4_BF16_FLIPS`` of
    its bf16 outputs differing; the ablation over 16 blocks of 1024 rows
    at h = 64 and 128 in each mode within ``PROBE_TOL``. The launches made
    here are not counted for the paths."""
    del gen
    errs = {}
    x, out = perf_call_floor.copy_inputs()
    got = probes.copy_probe(x, out)
    torch.cuda.synchronize()
    if not torch.equal(got, probes.copy_probe_reference(x)):
        raise AssertionError("copy_probe is not bit-equal to its plain version")
    errs["copy"] = dict(max_abs=0.0, bit_equal=True)
    log("[probes] copy_probe (8, 128) bf16: bit-equal")
    x, w, out = perf_call_floor.matmul_inputs()
    want = probes.matmul_probe_reference(x, w)
    for name, call in (("one call", lambda: probes.matmul_probe(x, w, out)),
                       ("four calls", lambda: perf_call_floor.four_calls(x, w, out))):
        out.fill_(float("nan"))
        got = call()
        torch.cuda.synchronize()
        rel, abs_err, flips = rel_err(f"matmul_probe {name}", got, want)
        errs[f"matmul {name}"] = dict(max_rel=rel, max_abs=abs_err, differing_share=flips)
        log(f"[probes] matmul_probe {name} ({perf_call_floor.M}, {perf_call_floor.K}) x "
            f"({perf_call_floor.K}, {perf_call_floor.N}) bf16: max err {rel:.3e} of max |ref| "
            f"({abs_err:.3e} abs; limit {PROBE_TOL:.3e}), {flips:.4%} of outputs differ "
            f"(limit {INT4_BF16_FLIPS:.0%})")
        if not (rel <= PROBE_TOL and flips <= INT4_BF16_FLIPS):
            raise AssertionError(f"matmul_probe {name}: err {rel}, {flips} differing")
    block = perf_flash_ceiling.BLOCK
    for h in perf_flash_ceiling.ABLATE_HEAD_DIMS:
        q, k, v = perf_flash_ceiling.ablation_inputs(h)
        for mode in perf_flash_ceiling.MODES:
            got = probes.ablate_probe(q, k, v, block=block, mode=mode)
            torch.cuda.synchronize()
            rel, abs_err, flips = rel_err(
                f"ablate_probe {mode} h={h}", got,
                probes.ablate_probe_online_reference(q, k, v, block=block, mode=mode))
            tpu_rel, _, _ = rel_err(f"ablate_probe {mode} h={h}", got,
                                    probes.ablate_probe_reference(q, k, v, block=block, mode=mode))
            errs[f"ablate {mode} h={h}"] = dict(max_rel=rel, max_abs=abs_err,
                                                differing_share=flips, tpu_order_max_rel=tpu_rel)
            log(f"[probes] ablate_probe {mode} h={h} ({perf_flash_ceiling.BLOCKS} blocks of "
                f"{block}): max err {rel:.3e} of max |ref| against the plain version in the "
                f"kernel's order (limit {PROBE_TOL:.3e}; {flips:.4%} of outputs differ), "
                f"{tpu_rel:.3e} against the TPU kernel's order")
            if not rel <= PROBE_TOL:
                raise AssertionError(f"ablate_probe {mode} h={h}: err {rel} > {PROBE_TOL}")
    probes.reset_launches()
    return errs


def check_1p4b_generate(label, fn, tree, prompt):
    """One rectangular generate of the audit's variant ``label`` at the
    1.4B shape, its launches counted from zero and held to
    ``want_generate_launches`` (decode attention's prefill on the tensor
    cores and every token step split; int4 fused: the prefill's matmuls and
    FFs on the tensor-core designs, the token steps' on the small-M ones),
    and its tokens teacher-forced against the dense bf16 model on the same
    weights (the quantized ones dequantized)."""
    mode = {"bf16": False, "int8 dequant": True, "int4 fused": "fused"}[label]
    cfg = AUDIT.CONFIG_1P4B
    want = want_generate_launches(cfg, mode, AUDIT.B, AUDIT.PROMPT, AUDIT.NEW)
    torch.cuda.synchronize()
    reset_launches()
    out = fn(tree, prompt)
    torch.cuda.synchronize()
    got = read_launches()
    log(f"[audit] {label}: one 1.4B generate launched {got}")
    if got != want:
        raise AssertionError(f"1.4B {label} generate launched {got}, want {want}")
    total = AUDIT.PROMPT + AUDIT.NEW
    check_output(out, AUDIT.B, total, cfg.vocab_size)
    tf_model = Transformer(dataclasses.replace(cfg, param_dtype=torch.bfloat16), device="cuda",
                           seed=1).eval()
    tf_model.load_state_dict(dequantize_tree(tree, torch.bfloat16))
    gap = teacher_forced_gap(tf_model, out, [AUDIT.PROMPT] * AUDIT.B, [total] * AUDIT.B)
    limit = QUANT_TF_GAP["fused"] if mode == "fused" else TF_GAP
    log(f"[audit] {label}: teacher-forced max gap {gap:.4f} against the dense bf16 model on "
        f"the same weights (limit {limit})")
    if not gap <= limit:
        raise AssertionError(f"1.4B {label} teacher-forced gap {gap} > {limit}")


def run_probe_paths(card):
    """The probe scripts through their own functions, as their ``main()``s
    run them, each with the probe counters set to 0 just before and read
    just after: the launch floor (``perf_call_floor``: copy and matmul
    probes), the launch audit at 1.4B (``perf_launch_audit``: the copy
    probe's floors in the same process; each variant's generate counted by
    ``check_1p4b_generate``) and the flash ceiling (``perf_flash_ceiling``,
    parts 1-4: the ablation probe; every flash launch of the composed steps
    on the tensor cores). Fails if a probe kernel of a path launched no
    time."""
    rows, launches, seconds = {}, {}, {}
    t0 = time.perf_counter()
    probes.reset_launches()
    rows["floor"] = {"copy": perf_call_floor.copy_floor(), "matmul": perf_call_floor.matmul_floor()}
    launches["floor"] = {"probe_copy": probes.copy_probe.launches,
                         "probe_matmul": probes.matmul_probe.launches}
    perf_call_floor.report(rows["floor"]["copy"], "(8, 128) bf16")
    perf_call_floor.report(rows["floor"]["matmul"], "(8, 2048) x (2048, 8192) bf16")
    seconds["floor"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    probes.reset_launches()
    rows["audit"] = perf_launch_audit.audit(check=check_1p4b_generate, log=log)
    launches["audit"] = {"probe_copy": probes.copy_probe.launches}
    seconds["audit"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    probes.reset_launches()
    ceiling = rows["flash_ceiling"] = {
        "part1": perf_flash_ceiling.kernel_bench(log=log),
        "part2": perf_flash_ceiling.composed_8k(log=log),
        "part3": perf_flash_ceiling.ablation(log=log),
        "part4": perf_flash_ceiling.composed_16k(log=log)}
    launches["flash_ceiling"] = {"probe_ablate": probes.ablate_probe.launches}
    seconds["flash_ceiling"] = time.perf_counter() - t0
    for part in ("part2", "part4"):
        for name, row in ceiling[part].items():
            calls = perf_flash_ceiling.STEPS_PER_CALL * perf_flash_ceiling.CONFIG_8K.num_layers
            if row["flash_launches"] != dict.fromkeys(FLASH_LAUNCH_KEYS, calls):
                raise AssertionError(f"flash ceiling {part} {name}: one call launched "
                                     f"{row['flash_launches']}, want {calls} of each on the "
                                     f"tensor cores")
    log(f"[probes] path launches (counted from zero around each script): {launches}; "
        f"seconds {dict((k, round(v, 1)) for k, v in seconds.items())}")
    for path, counts in launches.items():
        for name, n in counts.items():
            if n == 0:
                raise AssertionError(f"{path}: {name} never launched")
    return dict(rows, launches=launches, seconds=seconds)


def time_probes(paths, card):
    """The probes' numbers for the kernels line, at the scripts' shapes,
    queued: the kernels' and their library calls' from the scripts' own
    runs in ``paths`` (the floor: the copy against ``Tensor.copy_``, the
    one-call matmul against ``torch.matmul``; the ablation, ``full`` at
    h = 128, against SDPA at scale 1), beside the plain versions timed here
    on the same inputs and the bounds."""
    floor, ablation = paths["floor"], paths["flash_ceiling"]["part3"]
    blocks, block = perf_flash_ceiling.BLOCKS, perf_flash_ceiling.BLOCK
    x, _ = perf_call_floor.copy_inputs()
    copy_plain, _ = queued_time(probes.copy_probe_reference, x)
    xm, w, _ = perf_call_floor.matmul_inputs()
    mm_plain, _ = queued_time(probes.matmul_probe_reference, xm, w, inner=3, repeats=5)
    m, k, n = perf_call_floor.M, perf_call_floor.K, perf_call_floor.N
    rows = {
        "probe_copy": dict(ms=floor["copy"]["copy_probe"]["queued_ms"], plain_ms=copy_plain * 1e3,
                           library_ms=floor["copy"]["copy_"]["queued_ms"],
                           library_call="Tensor.copy_",
                           bound=bound(2 * x.numel() * x.element_size(), 0)),
        "probe_matmul": dict(ms=floor["matmul"]["matmul_probe"]["queued_ms"],
                             plain_ms=mm_plain * 1e3,
                             library_ms=floor["matmul"]["torch.matmul"]["queued_ms"],
                             library_call="torch.matmul",
                             bound=bound(2 * (m * k + k * n + m * n), 2 * m * k * n)),
    }
    h = 128
    q, kk, v = perf_flash_ceiling.ablation_inputs(h)
    ab_plain, _ = queued_time(probes.ablate_probe_reference, q, kk, v, block=block, mode="full",
                              inner=3, repeats=5)
    rows["probe_ablate"] = dict(
        ms=ablation[h]["full"] * blocks / 1e3, plain_ms=ab_plain * 1e3,
        library_ms=ablation[h]["sdpa"] * blocks / 1e3,
        library_call="scaled_dot_product_attention(scale=1.0)",
        bound=bound(4 * q.numel() * q.element_size(), probes.ablate_flops(blocks, block, h)))
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"] = row.pop("bound")
        log(f"[time] {name} (queued): {row['ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.3f} "
            f"us ({row['bound_by']}), plain {row['plain_ms'] * 1e3:.2f} us, {row['library_call']} "
            f"{row['library_ms'] * 1e3:.2f} us on {card}")
    return rows


def int4_designs_1p4b(m, k, n, ng, nw):
    """Every w4a16 launch the 1.4B sweep times at a site, bf16, group 128
    → {name: (design, tile rows, splits)}, the rule's pick first: each
    design the layout takes (``int4_designs``) and, where the rule takes the
    small-M design, that design at every split it takes."""
    rule, others = int4_designs(m, k, n, ng, 128, torch.bfloat16, False, nw)
    designs = [rule, *others]
    if rule[0] == "small_m":
        designs += [("small_m", None, sp) for sp in mm4.split_choices(k // 2, ng, 128)
                    if sp <= mm4.MAX_SMALL_M_SPLITS and ("small_m", None, sp) not in designs]
    return {f"{d[0]}/{d[2]}" if d[0] == "small_m" else design_name(d[0], d[1]): d
            for d in designs}


def decode_shapes_1p4b():
    """Decode attention's shapes at 1.4B (b = 8, 16 heads of 128, bf16) →
    [(name, query rows, index, cache slots)]: the generate's token step and
    prefill (``DECODE_1P4B``), then the prefill chunk over
    ``CHUNK_SWEEP_TILES`` at index 0 and as the cache's last chunk."""
    shapes = {(s, index, AUDIT.CONFIG_1P4B.max_seq_len): f"decode attention {name}"
              for name, (s, index) in DECODE_1P4B.items()}
    for tiles in CHUNK_SWEEP_TILES:
        length = tiles * da.TILE_K
        for index in (0, length - AUDIT.PROMPT):
            shapes.setdefault((AUDIT.PROMPT, index, length),
                              f"decode attention chunk at {index} of {tiles} tiles")
    return [(name, *shape) for shape, name in shapes.items()]


def check_1p4b_kernels(gen):
    """[probes] The int4 kernels and decode attention against their plain
    versions on the card at the launch audit's 1.4B shapes, bf16, group
    128. At M = 8 and 512: the q/k/v triple, the 2048² out projection and
    the lm_head through their public wrappers (counts as ``_variant``
    says) and at every ``int4_designs_1p4b`` launch; the FF 2048 → 8192 →
    2048 through ``int4_ff`` (counts as ``ff4._design`` says) and in every
    other design, up tile and down split; each within ``INT4_TOL`` of the
    largest |ref| with at most ``INT4_BF16_FLIPS`` of its outputs
    differing, every small-M and FF launch repeated bit-equal. Decode
    attention at every ``decode_shapes_1p4b`` shape, public, both designs
    in one piece and in ``CHECK_SPLITS``, and the public design at every
    ``SPLIT_SWEEP`` split, within ``TOL``. Exactly what
    ``time_designs_1p4b`` times → the largest error per kernel."""
    bf16, tol, cfg = torch.bfloat16, INT4_TOL[torch.bfloat16], AUDIT.CONFIG_1P4B
    worst = {}

    def hold(kernel, label, outs, wants, launch, repeat):
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        if repeat:
            again = launch()
            if not all(torch.equal(a, b) for a, b in zip(
                    outs, again if isinstance(again, (list, tuple)) else [again])):
                raise AssertionError(f"1.4B {label}: a second launch gave other bits")
        errs = [rel_err(label, got, want) for got, want in zip(outs, wants)]
        rel, abs_err, flips = map(max, zip(*errs))
        if not (rel <= tol and flips <= INT4_BF16_FLIPS):
            raise AssertionError(f"1.4B {label}: relative error {rel} (limit {tol}), "
                                 f"{flips} of outputs differ (limit {INT4_BF16_FLIPS})")
        old = worst.get(kernel, (0.0, 0.0, 0.0, 0))
        worst[kernel] = (max(old[0], rel), max(old[1], abs_err), max(old[2], flips), old[3] + 1)

    for site, (k, n, nw) in INT4_SITES_1P4B.items():
        nodes = [int4_weight(gen, k, n, 128) for _ in range(nw)]
        pairs = [(nd["q4"], nd["scale"]) for nd in nodes]
        ng = pairs[0][1].shape[0]
        kernel = "int4_matmul3" if nw == 3 else "int4_matmul"
        for m in ROWS_1P4B:
            x = randn(gen, m, k, dtype=bf16)
            wants = [mm4.int4_matmul_reference(x, *pair, group=128) for pair in pairs]
            designs = int4_designs_1p4b(m, k, n, ng, nw)
            rule = next(iter(designs.values()))

            def public():
                if nw == 3:
                    return mm4.int4_matmul3(x, pairs, group=128)
                return mm4.int4_matmul(x, *pairs[0], group=128)
            hold(kernel, f"{kernel} {site} m={m} public", counted(kernel, rule[0], public),
                 wants, public, rule[0] == "small_m")
            for key, d in designs.items():
                def launch(d=d):
                    return mm4._launch_w4a16(x, pairs, group=128, variant=d[0], tile_rows=d[1],
                                             splits=d[2])
                hold(kernel, f"{kernel} {site} m={m} {key}", launch(), wants, launch,
                     d[0] == "small_m")
        del nodes, pairs
        torch.cuda.empty_cache()
    k, hidden = cfg.features, cfg.hidden
    up, dn = int4_weight(gen, k, hidden, 128), int4_weight(gen, hidden, k, 128)
    args = (up["q4"], up["scale"], dn["q4"], dn["scale"])
    for m in ROWS_1P4B:
        x = randn(gen, m, k, dtype=bf16)
        want = [ff4.int4_ff_reference(x, *args, group=128)]
        rule, others = ff_designs(m, 128, bf16, k, hidden)

        def public():
            return ff4.int4_ff(x, *args, group=128)
        hold("int4_ff", f"int4_ff m={m} public", counted_ff(rule[0], public), want, public, True)
        for d in [rule, *others]:
            def launch(d=d):
                return ff4._launch_cuda(x, *args, group=128, design=d[0], up_rows=d[1],
                                        down_splits=d[2])[0]
            hold("int4_ff", f"int4_ff m={m} {ff_design_name(*d)}", launch(), want, launch, True)
    del up, dn, args
    torch.cuda.empty_cache()
    n_kv = cfg.num_kv_heads or cfg.num_heads
    for name, s, index, length in decode_shapes_1p4b():
        design = public_split(AUDIT.B, s, cfg.num_heads, n_kv, cfg.head_dim, length)[0]
        variants = list(dict.fromkeys(decode_variants(bf16)
                                      + [(design, sp) for sp in SPLIT_SWEEP]))
        err = kernel_case(f"1.4B {name}", gen, bf16, b=AUDIT.B, s=s, n=cfg.num_heads,
                          n_kv=n_kv, h=cfg.head_dim, length=length,
                          index=torch.full((), index, dtype=torch.int32, device="cuda"),
                          variants=variants)
        old = worst.get("decode_attention", (0.0, 0.0, 0.0, 0))
        worst["decode_attention"] = (0.0, max(old[1], err), 0.0, old[3] + len(variants) + 1)
    torch.cuda.synchronize()
    for kernel, (rel, abs_err, flips, cases) in worst.items():
        log(f"[probes] 1.4B {kernel}: {cases} launches held to the plain version, max err "
            + (f"{abs_err:.3e} abs (tol {TOL[bf16]:g})" if kernel == "decode_attention" else
               f"{rel:.3e} of the largest |ref| ({abs_err:.3e} abs; tol {tol:g}), at most "
               f"{flips:.2e} of outputs differ"))
    return {kernel: dict(zip(("max_rel", "max_abs", "differing_share", "cases"), v))
            for kernel, v in worst.items()}


def time_designs_1p4b(gen, card):
    """The design rules at the launch audit's 1.4B shape, bf16, group 128,
    queued: at the token step's rows (M = 8) and the prefill's (M = 512),
    every ``int4_designs_1p4b`` launch of each int4 site (the w4a16 q/k/v
    triple, the 2048² out projection, the lm_head), the FF 2048 → 8192 →
    2048 at every down split and both up tiles, and decode attention at
    every ``decode_shapes_1p4b`` shape over its split sweep; what
    ``check_1p4b_kernels`` held to the plain versions. Each row names the
    rule's pick and the fastest."""
    bf16, rows = torch.bfloat16, {}

    def record(label, rule, times):
        best = min(times, key=times.get)
        row = dict(rule=rule, rule_ms=times[rule], best=best, best_ms=times[best], ms=times)
        rows[label] = row
        log(f"[time] 1.4B {label}: the rule takes {rule} {times[rule] * 1e3:.2f} us, fastest "
            f"{best} {times[best] * 1e3:.2f} us; " + ", ".join(
                f"{d} {v * 1e3:.2f}" for d, v in times.items()) + f" us on {card}")

    for site, (k, n, nw) in INT4_SITES_1P4B.items():
        nodes = [int4_weight(gen, k, n, 128) for _ in range(nw)]
        pairs = [(nd["q4"], nd["scale"]) for nd in nodes]
        ng = pairs[0][1].shape[0]
        for m in ROWS_1P4B:
            x = randn(gen, m, k, dtype=bf16)
            designs = int4_designs_1p4b(m, k, n, ng, nw)
            times = {key: queued_time(mm4._launch_w4a16, x, pairs, group=128, variant=d[0],
                                      tile_rows=d[1], splits=d[2], inner=5, repeats=5)[0] * 1e3
                     for key, d in designs.items()}
            record(f"{site} m={m}", next(iter(designs)), times)
        del nodes, pairs
        torch.cuda.empty_cache()
    k, hidden = AUDIT.CONFIG_1P4B.features, AUDIT.CONFIG_1P4B.hidden
    up, dn = int4_weight(gen, k, hidden, 128), int4_weight(gen, hidden, k, 128)
    args = (up["q4"], up["scale"], dn["q4"], dn["scale"])
    for m in ROWS_1P4B:
        x = randn(gen, m, k, dtype=bf16)
        rule, others = ff_designs(m, 128, bf16, k, hidden)
        times = {ff_design_name(*d): queued_time(ff4._launch_cuda, x, *args, group=128,
                                                 design=d[0], up_rows=d[1], down_splits=d[2],
                                                 inner=5, repeats=5)[0] * 1e3
                 for d in [rule, *others]}
        record(f"ff m={m}", ff_design_name(*rule), times)
    cfg = AUDIT.CONFIG_1P4B
    for name, s_q, index, length in decode_shapes_1p4b():
        row = time_shape(gen, f"1.4B {name}", s=s_q, index=index, card=card, n=cfg.num_heads,
                         h=cfg.head_dim, length=length)
        sweep = {f"{row['design']}/{sp}": v for sp, v in row["split_sweep_ms"].items()}
        record(name, f"{row['design']}/{row['splits']}", sweep)
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
                                      "int4_ff", "fused_norm", "probes")))
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
                          r"(?:_rows|_tc|_combine)?"
                          r"|int4_matmul(?:_w4a8)?(?:_tc|_small_m)?"
                          r"|int4_ff(?:_reduce|_small_m|_up_tc|_down_tc)?"
                          r"|fused_norm_(?:fwd|bwd|reduce)"
                          r"|probe_(?:copy|matmul|ablate|colsum))_kernel)(?:I(\w+))?", line)
        if entry:
            kernel = entry.group(1) + (f"<{', '.join(template_args(entry.group(2)))}>"
                                       if entry.group(2) else "")
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

    marks = [time.perf_counter()]

    def mark(phase):
        """Log the seconds since the last mark: what each phase costs of the
        run's time limit."""
        marks.append(time.perf_counter())
        log(f"[phase] {phase}: {marks[-1] - marks[-2]:.1f} s (run {marks[-1] - marks[0]:.1f} s)")

    build_kernels()
    mark("build")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = check_kernel(gen)
    int8_errs = check_kernel(gen, int8=True)
    paged_errs = check_paged(gen)
    flash_errs = check_flash(gen)
    int4_errs, int4_design_errs, w4a8_unequal = check_int4(gen)
    norm_errs = check_fused_norm(gen)
    mark("kernel checks")

    model = Transformer(CONFIG_125M, device="cuda", seed=0)
    params = model.state_dict()
    tf_cfg = dataclasses.replace(CONFIG_125M, param_dtype=torch.bfloat16)
    tf_model = Transformer(tf_cfg, device="cuda", seed=1).eval()
    tf_model.load_state_dict(params)
    del model
    main_path = run_main_path(params, gen, tf_model, card)
    breakdown = profile_generate(params, gen, main_path["ms_per_step"])
    fused_gen = run_fused_generate(params, gen, tf_model, card)
    del tf_model
    torch.cuda.empty_cache()
    int8_gen = run_int8_generate(params, gen, card)
    decode_int8 = time_decode_int8(gen, card)
    torch.cuda.empty_cache()
    mark("125M generate paths")

    q4, q_prompt, quant, int4_fns = run_quantized_path(params, gen)
    ladder, fused_fn = run_ladder(params, q4, q_prompt, card, int4_fns)
    int4_prefill = time_int4_prefill(q4, q_prompt, card)
    int4_decode = time_int4_decode(q4, q_prompt, card, int4_fns)
    quant_breakdown = int4_decode["int4-fused"]["profile"]
    del fused_fn, int4_fns
    torch.cuda.empty_cache()
    mark("int4 generate paths")
    engine = run_engine_path(params, q4, card)
    mark("engine")
    decode_times = time_decode_designs(gen, card)
    del params, q4
    torch.cuda.empty_cache()
    int4_times = time_int4(gen, card)
    torch.cuda.empty_cache()
    mark("decode attention and int4 kernel times")

    step = step_check(train_batch(gen, CONFIG_125M.vocab_size))
    torch.cuda.empty_cache()
    train = run_train_path(gen, card)
    torch.cuda.empty_cache()
    fused_train = run_fused_train_path(gen, card)
    torch.cuda.empty_cache()
    mark("train paths")
    flash_times, sdpa_times = time_flash(gen, card)
    norm_times = time_fused_norm(gen, card)
    torch.cuda.empty_cache()
    mark("flash and fused-norm kernel times")

    probe_errs = check_probes(gen)
    errs_1p4b = check_1p4b_kernels(gen)
    probe_paths = run_probe_paths(card)
    probe_times = time_probes(probe_paths, card)
    mark("probes")
    designs_1p4b = time_designs_1p4b(gen, card)
    mark("1.4B design sweep")
    log(f"[time] measured on {card}")

    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    decode = decode_times["decode"]
    warm = engine["runs"]["paged+prefix warm"]
    entries = [dict(
        name="decode_attention", route="cuda", source=KERNEL_SOURCE, replaces=REPLACES,
        launches=main_path["rect_launches"], ragged_launches=main_path["ragged_launches"],
        max_abs_err=errs[torch.bfloat16],
        max_err_bf16=errs[torch.bfloat16], max_err_fp32=errs[torch.float32],
        **{k: decode[k] for k in timing_keys},
        # The two designs: the token step's (top level) and the prefill's
        # design and split, the rectangular generate's launches on each, and
        # the first design (cuda_core, one piece) on the same inputs.
        design={name: f"{decode_times[name]['design']}/{decode_times[name]['splits']}"
                for name in ("decode", "prefill")},
        splits=decode["splits"],
        tensor_core_launches=main_path["decode_attention_tensor_core"],
        split_launches=main_path["decode_attention_split"],
        cuda_core_design_ms=decode["cuda_core_design_ms"],
        shapes={"prefill": decode_times["prefill"], "decode": decode},
        # The int8 cache mode: its checks, its launches in the int8-cache
        # generate, and its queued time beside the bf16 cache's at decode.
        int8=dict(max_abs_err=int8_errs[torch.bfloat16], max_err_bf16=int8_errs[torch.bfloat16],
                  max_err_fp32=int8_errs[torch.float32], launches=int8_gen["launches"],
                  **{k: decode_int8["int8"][k] for k in timing_keys},
                  bf16_cache_queued=decode_int8["bf16"]),
    )]
    # The paged mode: its checks over every PAGED_CASES shape, its launches in
    # the warm paged + prefix serve, its queued time at the engine's decode
    # shape beside the contiguous kernel's on the same values.
    entries.append(dict(
        name="decode_attention_paged", route="cuda", source=KERNEL_SOURCE, replaces=REPLACES,
        launches=engine["paged_launches"],
        max_abs_err=max(paged_errs[torch.bfloat16, q] for q in (False, True)),
        max_err_bf16=max(paged_errs[torch.bfloat16, q] for q in (False, True)),
        max_err_fp32=max(paged_errs[torch.float32, q] for q in (False, True)),
        **{k: decode_times["paged_decode"][k] for k in timing_keys},
        contiguous_ms=decode_times["paged_decode"]["contiguous_ms"],
        # The engine's token step (top level) and refill: design and split,
        # the warm serve's launches on the tensor cores (its refill chunks)
        # and split, and the first design on the same pools.
        design={name: f"{decode_times[key]['design']}/{decode_times[key]['splits']}"
                for name, key in (("decode", "paged_decode"), ("refill", "paged_refill"))},
        splits=decode_times["paged_decode"]["splits"],
        tensor_core_launches=warm["launches"]["decode_attention_tensor_core"],
        split_launches=warm["launches"]["decode_attention_split"],
        cuda_core_design_ms=decode_times["paged_decode"]["cuda_core_design_ms"],
        shapes={"decode": decode_times["paged_decode"], "prefill": decode_times["paged_refill"]},
    ))
    for name in ("fwd", "bwd_dkv", "bwd_dq"):
        public = (flash._fwd_design if name == "fwd" else flash._bwd_design)(torch.bfloat16, 64)
        entry = dict(
            name=f"flash_{name}", route="cuda", source=FLASH_SOURCE,
            replaces=FLASH_REPLACES[name], launches=train["launches"][name],
            max_abs_err=flash_errs[torch.bfloat16, public, "abs"][name],
            max_err_bf16=flash_errs[torch.bfloat16, public, "checked"][name],
            max_err_fp32=flash_errs[torch.float32, "cuda_core", "checked"][name],
            **{k: flash_times[name][k] for k in timing_keys},
            bytes=flash_times[name]["bytes"], ops=flash_times[name]["ops"],
            tflop_s=flash_times[name]["tflop_s"],
            # The design bf16 takes (fp32 stays on the CUDA cores), its
            # launches in the 8-step call, and the CUDA-core design's time and
            # errors on the same inputs.
            design=f"{public} (bf16); cuda_core (fp32)",
            tensor_core_launches=train["launches"][f"{name}_tensor_core"],
            cuda_core_ms=flash_times[name]["cuda_core_ms"],
            cuda_core_tflop_s=flash_times[name]["cuda_core_tflop_s"],
            cuda_core_max_err_bf16=flash_errs[torch.bfloat16, "cuda_core", "checked"][name],
        )
        if name != "fwd":
            # The backward pair once more on the public forward's out/lse.
            entry["chained_max_err_bf16"] = flash_errs[torch.bfloat16, "chained", "checked"][name]
        entries.append(entry)
    # The int4 kernels: top-level numbers at the 768 x 768 decode site (q, k,
    # v, out: most of the launches; the small-M design), the prefill site
    # (M=1024; the tensor-core design) under "prefill", every timed site and
    # every design under "shapes" (at decode rows also HBM-cold).
    main_site = {"int4_matmul": "qkv_out m=8", "int4_matmul_w4a8": "qkv_out m=8",
                 "int4_matmul3": "qkv m=8", "int4_ff": "ff m=8"}
    prefill_site = {"int4_matmul": "lm_head m=1024", "int4_matmul_w4a8": "lm_head m=1024",
                    "int4_matmul3": "qkv m=1024"}
    main_run = {"int4_matmul": "fused", "int4_matmul_w4a8": "fused_w4a8",
                "int4_matmul3": "fused", "int4_ff": "fused"}
    for name in INT4_KERNELS:
        row = int4_times[name][main_site[name]]
        launches = quant[main_run[name]]["launches"]
        entry = dict(
            name=name, route="cuda", source=INT4_FF_SOURCE if name == "int4_ff" else INT4_SOURCE,
            replaces=INT4_REPLACES[name], launches=launches[name],
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
        )
        if name in prefill_site:
            entry.update(
                variant={"decode (M=8)": row["variant"],
                         "prefill (M=1024)": int4_times[name][prefill_site[name]]["variant"]},
                tensor_core_launches=launches[f"{name}_tensor_core"],
                small_m_launches=launches[f"{name}_small_m"],
                small_m_splits=row["small_m_splits"], cuda_core_ms=row["cuda_core_ms"],
                hbm_cold=row["hbm_cold"],
                variants=f"small_m for up to {mm4.SMALL_M_ROWS} rows of bf16 (w4a16) or int8 "
                         "(w4a8) whose K/2 and groups are multiples of 32 packed rows, split "
                         "over K into the warps of a block (_splits); past them tensor_core "
                         "for such layouts once the CUDA-core grid (N/32 x M/8 blocks) exceeds "
                         f"{mm4.CUDA_CORE_BLOCKS_PER_SM[False]} (w4a16) or "
                         f"{mm4.CUDA_CORE_BLOCKS_PER_SM[True]} (w4a8) an SM, else cuda_core "
                         "(ops/int4_matmul.py::_variant); w4a16 tiles of 128 or 96 rows, "
                         "whichever leaves the busiest SM the fewest rows (_tile_rows)",
                prefill=int4_times[name][prefill_site[name]],
                errors_by_design={f"{design} {str(dtype)[6:]}": dict(
                    zip(("max_rel", "max_abs", "differing_share", "cases"), v))
                    for (kernel, design, dtype), v in int4_design_errs.items() if kernel == name})
        if name == "int4_ff":
            prefill = int4_times[name]["ff m=1024"]
            entry.update(
                variant={"decode (M=8)": row["design"], "prefill (M=1024)": prefill["design"],
                         "refill (M=512)": int4_times[name][f"ff m={B * PAGED_CHUNK}"]["design"]},
                tensor_core_launches=launches["int4_ff_tensor_core"],
                small_m_launches=launches["int4_ff_small_m"], cuda_core_ms=row["cuda_core_ms"],
                hbm_cold=row["hbm_cold"], prefill=prefill,
                instantiations=sorted(k for k, _, _ in ptxas_usage(
                    _build.reports.get("int4_ff", "")) if k.startswith("int4_ff")),
                variants=f"small_m for up to {mm4.SMALL_M_ROWS} rows of bf16 x (both products "
                         "on mma.sync, one launch, partials summed through a cluster's "
                         "distributed shared memory and by the last cluster); tensor_core for "
                         "bf16 x past them (an up launch with the GELU writing u as three "
                         "bf16 parts, a down launch on the integer nibbles, split over the "
                         "scale groups by _down_splits); cuda_core for fp32 x and other "
                         "layouts (ops/int4_ff.py::_design)",
                errors_by_design={f"{design} {str(dtype)[6:]}": dict(
                    zip(("max_rel", "max_abs", "differing_share", "cases"), v))
                    for (kernel, design, dtype), v in int4_design_errs.items() if kernel == name})
        if name == "int4_matmul_w4a8":
            entry["not_bit_equal"] = w4a8_unequal
        entries.append(entry)
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
    # The probe kernels: launches from their scripts' runs (run_probe_paths),
    # errors from check_probes, times from time_probes.
    probe_err_keys = {"probe_copy": ["copy"], "probe_matmul": ["matmul one call", "matmul four calls"],
                      "probe_ablate": [k for k in probe_errs if k.startswith("ablate")]}
    for name, keys in probe_err_keys.items():
        row = probe_times[name]
        entries.append(dict(
            name=name, route="cuda", source=PROBES_SOURCE, replaces=PROBES_REPLACES[name],
            launch_sites=PROBES_SITES[name],
            launches=sum(c.get(name, 0) for c in probe_paths["launches"].values()),
            launches_by_path={p: c[name] for p, c in probe_paths["launches"].items() if name in c},
            max_abs_err=max(probe_errs[k]["max_abs"] for k in keys),
            max_err=max(probe_errs[k].get("max_rel", 0.0) for k in keys),
            **{k: row[k] for k in timing_keys}, library_call=row["library_call"],
            errors={k: probe_errs[k] for k in keys},
        ))
    entries[-3]["floor"] = probe_paths["floor"]["copy"]
    entries[-2]["floor"] = probe_paths["floor"]["matmul"]
    entries[-1]["shapes"] = {f"h={h} {mode}": us for h, r in
                             probe_paths["flash_ceiling"]["part3"].items() for mode, us in r.items()}
    generate = dict(tok_s=main_path["tok_s"], ms_per_token_step=main_path["ms_per_step"],
                    teacher_forced_max_gap=main_path["gap"], step_breakdown=breakdown)
    quantized = dict(runs=quant, ladder=ladder, int4_fused_step_breakdown=quant_breakdown,
                     int4_prefill=int4_prefill,
                     int4_decode={k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                                  | {"busy_ms_per_step": v["profile"]["busy_ms_per_step"]}
                                  for k, v in int4_decode.items()})
    print(json.dumps({"kernels": entries, "generate": generate, "quantized": quantized,
                      "train": train, "train_step_check": step, "sdpa": sdpa_times,
                      "fused_norm_train": fused_train, "fused_norm_generate": fused_gen,
                      "int8_cache_generate": int8_gen, "engine": engine,
                      "launch_audit": probe_paths["audit"],
                      "flash_ceiling": probe_paths["flash_ceiling"],
                      "designs_1p4b": designs_1p4b, "checks_1p4b": errs_1p4b}, default=str))
    print(card)
    print(json.dumps(result_line(torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
