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
down launch), the fused residual+norm forward and backward in both designs
(row groups, which the public path takes, and the first, a warp a row) at
768, 2048, 1001 and 16384 features, and the wide kernels at 16385, 24576
and 32768, two backward launches bit-equal). Then
drives the port's main paths at
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
dense forward; the engine's decoding modes (``[engine] modes``: mixed, mixed
at horizon 4, self-draft speculation unpaged and paged with the prefix
cache, sampling split and speculative; decode attention at the verify
chunk's shape against its plain version; teacher-forced gaps, one host sync
a horizon, sampled tokens in the filtered support and unchanged when the
queue is admitted in reverse order, launches per model call and round;
timed interleaved and profiled); and the train step (flash attention, fused loss, AdamW, b=8,
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
launch on the tensor cores, and the ablation); the 1.4B generate with
``fused_norm=True`` (2048 features), teacher-forced and timed against the
plain-norm one; then the design rules timed at the 1.4B shape. The mesh
phases (slice A): ``[mesh] 1x1``, the fused-norm train step and the float,
int4-fused and w4a8 generates over a one-rank cuda mesh (DTensor
parameters, the kernels through their per-shard wrappers) against the
unsharded calls: the same launches, the same tokens, the same losses,
both timed interleaved, and the weights' layout over the mesh timed
alone; ``[mesh] 2x2 on one card``, a (2, 2) data x model mesh whose four
ranks are threads of this process (four processes cannot share the one
card: NCCL refuses it, and gloo's all-gather of CUDA tensors hangs), the
train call and the float and int4-fused generates of
``scripts/mesh_cards.py`` through the mesh wrappers against the unsharded
calls (losses, teacher-forced tokens, every rank's launches); and ``[mesh]
shards``, every shard of a (2, 2) and a (2, 4) layout of the mesh paths'
main shapes through the kernels, stitched and held to the whole, each
shard's launch held to the design rule at its shape. ``[engine] mesh``
(slice 16): the 125M engine over a one-rank cuda mesh against no mesh
(the same launches and tokens, the host time a model call added), then
four thread ranks on a (2, 2) mesh serving split, paged + prefix (cold,
warm) and self-draft speculative (every rank's tokens and stats equal,
decode attention once a layer per model call on each rank, warm prefix
hits, teacher-forced gaps), and decode attention at the shard shapes the
ranks launched held to its plain version in every design and split, then
timed. ``[engine] policies`` (slice 17): the engine with its telemetry
attached (registry, tracer, flight recorder, SLO monitor, trace sink) on
the first 8 requests, paged + prefix: tokens equal to the ``[engine]``
phase's, decode attention once a layer per model call, the goodput
ledger's reconciliation, its buckets and telemetry share, a
``utils/profiling.trace`` capture holding the engine's ranges; then the
recovery policies: a deadline eviction, a shed, a sticky-fault quarantine
(batchmates bit-equal) and degraded speculation under an unreachable SLO.
``[train] remat`` (slice 20): the 125M train step (``make_train_step``)
under block remat with each policy (None, "dots", "dots_no_batch"), with
``scan_layers=True`` and with remat + ``fused_norm=True``, each variant's
first step from the plain step's weights counted and held bit for bit to
its twin without remat (the plain or the fused-norm step): the flash
forward launched again in the backward (24 a step, dK/dV and dQ 12) and
the fused-norm forwards likewise, full remat's peak memory below the plain
step's, each variant timed. ``[beam]`` (slice 20): beam search at the full width of GPT-2 small
(the config from its published ``GPT2Config`` fields, seeded weights
through the HF export and import, bit-equal), decode attention at the
search's shapes against its plain version, beam 1 against greedy generate
and beam 4 on the blocked against the dense backend in fp32, the scores
against a dense forward, one bf16 search counted, timed and profiled.
``[train] precision``, ``[train] zero1`` and ``[train] lora`` (slice D's
optimizer wrappers): the 125M fused-norm train step in bf16 parameters
under ``with_ema(master_weights(adamw))`` (launches as the plain step's;
every parameter on JAX's delta arithmetic from its fp32 master, the EMA on
a host recompute; a generate from ``ema_params``; ms a step, memory and
optimizer-state bytes against the plain fp32 AdamW step); the same steps
on a (2, 1) data mesh of thread ranks with the state ZeRO-1 split (losses
against the one card's, each rank half its state bytes); and rank-8 LoRA
over the frozen base (step 0's loss the base's bit for bit, the base
unchanged, a generate from ``merge_lora``'s tree). Slice 22: ``[train]
sequence parallel`` (``bench.py::bench_longcontext``'s step on a (2, 2)
mesh of thread ranks with ring attention, under remat, and with Ulysses
over the flash kernels, against one-card steps of the same weights),
``[train] moe`` (the 125M MoE step, E=8, top-2, the scatter dispatch,
against the einsum one; its flash launches, descent and aux losses; timed
beside the dense step), ``[generate] moe`` and ``[mesh] moe a2a``
(``moe_a2a_ff`` on a (2, 1) thread mesh against the grouped einsum).
Each path's kernel
launches are counted from zero around one run. Times the paths and the kernels, profiles the paths,
and prints the ``kernels`` JSON line, the card's name and power limit, and
last the JSON ``{"ok": true, "device": ...}``. Every phase raises on
failure. Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

from learning_jax_sharding_tpu_torch.data import CyclicLMDataset
from learning_jax_sharding_tpu_torch.models.attention import quantize_kv_chunk
from learning_jax_sharding_tpu_torch.models.beam import make_beam_search_fn
from learning_jax_sharding_tpu_torch.models.convert import (
    config_from_hf_gpt2,
    params_from_hf_gpt2,
    shard_params,
    stack_scan_params,
    state_dict_from_params,
    unstack_scan_params,
)
from learning_jax_sharding_tpu_torch.models.decoding import (
    apply_dequantize_policy,
    derive_decode_config,
    make_cached_apply,
    make_param_caster,
)
from learning_jax_sharding_tpu_torch.models import moe as moe_models
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
from learning_jax_sharding_tpu_torch.telemetry import GoodputLedger, MetricsRegistry, Tracer
from learning_jax_sharding_tpu_torch.training.checkpoint import CheckpointManager
from learning_jax_sharding_tpu_torch.training.ema import ema_params, with_ema
from learning_jax_sharding_tpu_torch.training.lora import (
    lora_train_state,
    make_lora_train_step,
    merge_lora,
)
from learning_jax_sharding_tpu_torch.training.precision import master_weights
from learning_jax_sharding_tpu_torch.training.zero import state_bytes
from learning_jax_sharding_tpu_torch.training.loop import (
    TrainLoopConfig,
    adamw,
    evaluate,
    fit,
    sgd,
)
from learning_jax_sharding_tpu_torch.training.pipeline import (
    make_eval_step,
    make_train_step,
    sharded_train_state,
)
from learning_jax_sharding_tpu_torch.utils.memory import device_hbm_bytes, memory_plan
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
# [train] fit: steps of the uninterrupted run, the resumed run's first
# part, checkpoint interval, evaluate's batches, the lion/adafactor runs.
FIT_STEPS, FIT_RESUME_AT, FIT_CKPT_EVERY, FIT_EVAL_BATCHES, FIT_OPT_STEPS = 12, 8, 4, 4, 5
# The descent gate: evaluate's loss over the first FIT_EVAL_BATCHES
# batches of the stream (those of steps 1-4) must fall by this many nats
# over the 12 steps. Weights that did not move score the same loss to the
# bit; the stream's batches differ from each other by more than the loss
# falls from one step to the next, so the step losses cannot show it.
FIT_DESCENT_MARGIN = 0.1
FIT_TIME_STEPS = 8   # the timed fit without checkpoints
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
# The timed depths, cut to pay for later phases (no gate reads them): the
# decode ladder's interleaved rounds and those of [engine]'s and [engine]
# modes' timed serves (3 until slice 21, 2 until slice 22: one round of each
# took about 10 s and 25 s on an H100 host), and the int4 generates timed
# against their CUDA-core designs (time_int4_decode): +16 tokens (the main
# path's +128 is checked and laddered above; +64 until slice 22, whose five
# generates took about 17 s at three calls each).
LADDER_ROUNDS = 1
ENGINE_TIME_ROUNDS = 1
INT4_TIME_NEW = 16
# [mesh] 1x1's train step and [engine] mesh's one-rank serve, each timed
# interleaved with its unsharded twin: one round (3 until slice 22; a
# round took about 2.5 s and 2.9 s on an H100 host).
MESH_TIME_ROUNDS = 1
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
# Every other cache size from 4 to 12 tiles (every one until slice 22: the
# nine sizes' checks and split sweeps refitted SPLIT_TARGET_BLOCKS in slice
# 12; the five keep both ends and the middle).
CHUNK_SWEEP_TILES = tuple(range(4, 13, 2))
NORM_SOURCE = "learning_jax_sharding_tpu_torch/csrc/fused_norm.cu"
NORM_REPLACES = {"fwd": "learning_jax_sharding_tpu/ops/fused_norm.py:57",
                 "bwd": "learning_jax_sharding_tpu/ops/fused_norm.py:82"}
# Row counts at M=768: the train step (b=8 × s=1024), a prefill of 8 × 128,
# a decode step of 8 rows, and one that is not a power of two.
NORM_ROWS = {"train": TRAIN_B * TRAIN_S, "prefill": B * PROMPT, "decode": B, "odd": 37}
# Other widths and their row counts: the 1.4B width (its decode and prefill
# rows, and a train-sized block), one that is a multiple of neither 8 nor 4
# (one-element loads), the widest one pass holds, and past it (the wide
# kernels: one-element loads at 16385, two segments at 24576 and 32768).
NORM_WIDTHS = {768: tuple(NORM_ROWS.values()), 2048: (AUDIT.B, AUDIT.B * AUDIT.PROMPT, 2048),
               1001: (AUDIT.B, 37), norm_ops.PASS_FEATURES: (4, 64), 16385: (4, 37),
               24576: (4, 64), 32768: (8, 16)}
# The designs checked and timed: the public one and the first (which takes
# features a multiple of 8 up to 1024).
NORM_DESIGNS = ("row_group", "warp_row")
# The wide kernels' timed shape: 64 rows of 32768 features (two passes).
WIDE_NORM_ROWS, WIDE_NORM_WIDTH = 64, 32768
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
               fold=False, window=None, int8=False, variants=None):
    """The paged kernel against its plain version, and against the
    contiguous kernel on the same values permuted into pages, through the
    public call and in every ``decode_variants`` launch (or each ``(design,
    splits)`` of ``variants``) → the largest max abs error against the
    plain version. Row indices are drawn from [lo, hi).
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
    for design, splits in [(None, None)] + (variants or decode_variants(dtype)):
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


def norm_design(name):
    """The ``design`` argument of the fused-norm wrappers for a design name."""
    return None if name == "row_group" else name


def check_fused_norm(gen):
    """The fused-norm kernels against their plain versions on the card, in
    fp32 and bf16, every design (``NORM_DESIGNS``, where it takes the width)
    at every ``NORM_WIDTHS`` width and row count and every ``NORM_CASES``
    kind; bf16 rows of up to 1024 also with bf16 parameters (generation
    casts them). Forward with and without the statistics; backward from the
    plain forward's statistics, with ``dr`` when there is a residual, twice
    for the public design, whose two launches must give the same bits → per
    (kernel, dtype, design) the largest relative (checked) and absolute
    error and differing bf16 share."""
    worst = {}

    def note(kernel, dtype, design, label, name, got, want, tol):
        errs = rel_err(f"{label} {name}", got, want)
        old = worst.get((kernel, dtype, design), (0.0, 0.0, 0.0))
        worst[kernel, dtype, design] = tuple(map(max, old, errs))
        if not errs[0] <= tol:
            raise AssertionError(f"fused_norm {label} {name}: relative error {errs[0]} > {tol}")
        if want.dtype == torch.bfloat16 and not errs[2] <= INT4_BF16_FLIPS:
            raise AssertionError(f"fused_norm {label} {name}: {errs[2]} of bf16 outputs differ "
                                 f"from the plain version's > {INT4_BF16_FLIPS}")
        return errs

    for m, row_counts in NORM_WIDTHS.items():
        designs = [d for d in NORM_DESIGNS if d != "warp_row"
                   or (m % 8 == 0 and m <= norm_ops.WARP_ROW_MAX_FEATURES)]
        for dtype in (torch.float32, torch.bfloat16):
            for rows in row_counts:
                params = [torch.float32] + ([torch.bfloat16] if dtype == torch.bfloat16
                                            and rows <= B * PROMPT else [])
                for param_dtype in params:
                    for kind, resid, beta in NORM_CASES:
                        t = norm_inputs(gen, rows, dtype, param_dtype, resid, beta, m)
                        args = (t["x"], t["res"], t["g"], t["b"])
                        kw = dict(eps=1e-6, kind=kind)
                        ref = norm_ops.fused_residual_norm_reference(*args, **kw, needs_stats=True)
                        r_full = ref[1] if resid else t["x"]
                        bwd_args = (t["dy"], r_full, t["g"], ref[2], ref[3], t["dr"])
                        bkw = dict(kind=kind, has_beta=beta)
                        want = norm_ops.fused_residual_norm_bwd_reference(*bwd_args, **bkw)
                        for design in designs:
                            label = (f"{design} {rows}x{m} {kind}{' +resid' if resid else ''}"
                                     f"{' +beta' if beta else ''} "
                                     f"{str(dtype)[6:]}/{str(param_dtype)[6:]}")
                            errs = []
                            for stats in (True, False):
                                got = norm_ops._fwd(*args, **kw, needs_stats=stats,
                                                    design=norm_design(design))
                                errs.append(note("fwd", dtype, design, label, "y", got[0],
                                                 ref[0], NORM_TOL[dtype]))
                                if resid and not torch.equal(got[1], ref[1]):
                                    raise AssertionError(f"fused_norm {label}: new residual "
                                                         f"differs")
                                if stats:
                                    for name, g, w in (("mean", got[2], ref[2]),
                                                       ("rstd", got[3], ref[3])):
                                        if w is not None:
                                            note("fwd", torch.float32, design, label, name, g, w,
                                                 NORM_TOL[torch.float32])
                            got = norm_ops._bwd(*bwd_args, **bkw, design=norm_design(design))
                            errs.append(note("bwd", dtype, design, label, "dx", got[0], want[0],
                                             NORM_TOL[dtype]))
                            # dgamma/dbeta: fp32 column sums, cast to gamma's dtype.
                            for name, g, w in (("dgamma", got[1], want[1]),
                                               ("dbeta", got[2], want[2])):
                                if w is not None:
                                    note("bwd", param_dtype, design, label, name, g, w,
                                         NORM_TOL[param_dtype])
                            if design == "row_group":
                                again = norm_ops._bwd(*bwd_args, **bkw)
                                if not all(torch.equal(a, b) for a, b in zip(got, again)
                                           if a is not None):
                                    raise AssertionError(f"fused_norm {label}: two backward "
                                                         f"launches differ")
                            flips = (f"; differing bf16 outputs {max(e[2] for e in errs):.2e} "
                                     f"(limit {INT4_BF16_FLIPS:g})"
                                     if dtype == torch.bfloat16 else "")
                            log(f"[norm] {label}: y {errs[0][0]:.2e} (no stats {errs[1][0]:.2e}), "
                                f"dx {errs[2][0]:.2e} of the largest |ref|{flips}"
                                + ("; two backward launches bit-equal"
                                   if design == "row_group" else ""))
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
               port_kernels_ms_per_step=ported, port_kernels_per_step=prof["port_by_name"])
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
    # Fused-norm kernels a step: one forward and one backward launch a norm
    # (the backward's dgamma/dbeta in the same launch; the launch counters
    # above hold the exact count, the profiler can miss an event or two).
    norm_kernels = {k: v for k, v in profile["port_kernels_per_step"].items()
                    if k.startswith("fused_norm_")}
    norm_ms = sum(v for k, v in profile["port_kernels_ms_per_step"].items()
                  if k.startswith("fused_norm_"))
    want_kernels = 2 * norm_calls(CONFIG_125M)
    log(f"[profile] 125M train step, fused_norm: fused-norm kernels a step {norm_kernels} "
        f"(want {want_kernels} in all), {norm_ms:.4f} ms a step")
    if (abs(sum(norm_kernels.values()) - want_kernels) > 1
            or any("warp_row" in k for k in norm_kernels)):
        raise AssertionError(f"fused-norm train step ran {norm_kernels} fused-norm kernels a step")
    profile["fused_norm_ms_per_step"] = norm_ms
    del states
    return dict(launches=norm, flash_launches=flash_launches, descent_losses=losses,
                step_check=check, timing=timing, profile=profile)


def fit_model(**fields):
    """The seeded 125M model of ``[time] 125M train step`` (flash attention)."""
    cfg = dataclasses.replace(CONFIG_125M, attn_fn=flash.make_flash_attn_fn(), **fields)
    return Transformer(cfg, device="cuda", seed=0)


def fit_config(**fields):
    return TrainLoopConfig(global_batch_size=TRAIN_B, learning_rate=3e-4, **fields)


def poisoned_loss(y, batch, model):
    """The fused loss, times NaN when the batch carries a nonzero
    ``poison`` (the JAX package's ``TestSkipGuard`` poisoning): loss and
    gradients go non-finite inside the step."""
    loss = fused_next_token_loss(y, batch, model, chunk_size=128)
    bad = batch["poison"].sum() > 0
    return loss * torch.where(bad, torch.tensor(float("nan"), device=loss.device),
                              torch.tensor(1.0, device=loss.device))


def state_tensors(state) -> dict:
    """Every parameter and optimizer slot of a train state, by name."""
    out = {}
    for name, p in state.model.named_parameters():
        out[name] = p.detach()
        for slot, v in state.optimizer.state.get(p, {}).items():
            out[f"{name}/{slot}"] = v
    return out


def run_fit_path(gen, card, step_ms):
    """``[train] fit``: the port's training loop at the train step's shape
    (125M, b=8, s=1024, bf16 compute, flash, the fused loss, AdamW) on a
    learnable stream from seeded weights: 12 steps with checkpoints every 4
    (2 kept), prefetch 2, a registry, tracer and ledger; 8 steps and a
    fresh model's resume to 12; ``evaluate`` over the first 4 batches
    before and after; one guarded step on a poisoned batch; 5 steps with
    lion (and ``fused_norm=True``) and 5 with adafactor. Gates: descent
    (evaluate's loss falls by ``FIT_DESCENT_MARGIN`` nats), the resumed
    losses 9-12 within rtol 1e-6 of the uninterrupted run's, the restored
    parameters and moments equal to the saved ones, 12 launches of each
    flash kernel a step on the tensor cores, the guarded step leaving every
    parameter and moment bit-equal, the ledger's reconciliation. Prints the
    loop's steady ms/step, tok/s and MFU beside ``step_ms`` (the bare
    8-step call's), the checkpoint's save and restore times, and the memory
    plan beside the peak allocation."""
    import tempfile

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="fit_", dir=root)
    stream = CyclicLMDataset(CONFIG_125M.vocab_size, TRAIN_S, seed=0)
    kw = dict(loss_fn=TRAIN_LOSS["loss_fn"], step_kwargs={
        k: v for k, v in TRAIN_LOSS.items() if k != "loss_fn"})
    flops = CONFIG_125M.train_step_flops(TRAIN_B, TRAIN_S)
    out = {}
    try:
        # The uninterrupted run, every phase's telemetry attached.
        registry, tracer, ledger = MetricsRegistry(), Tracer(), GoodputLedger()
        model = fit_model()
        ev0 = evaluate(sharded_train_state(model, adamw(3e-4)), stream, None, None,
                       batch_size=TRAIN_B, num_batches=FIT_EVAL_BATCHES, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.flash_attention.launches = dict.fromkeys(flash.flash_attention.launches, 0)
        t0 = time.perf_counter()
        state, hist = fit(model, stream, None, None, fit_config(
            steps=FIT_STEPS, checkpoint_dir=os.path.join(tmp, "full"),
            checkpoint_every=FIT_CKPT_EVERY, max_checkpoints=2, prefetch=2,
            metrics_path=os.path.join(tmp, "metrics.jsonl")),
            registry=registry, tracer=tracer, ledger=ledger, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = dict(flash.flash_attention.launches)
        losses = [h["loss"] for h in hist]
        want = FIT_STEPS * CONFIG_125M.num_layers
        log(f"[train] fit, {FIT_STEPS} steps (checkpoints every {FIT_CKPT_EVERY}, prefetch 2): "
            f"losses {[round(x, 4) for x in losses]}; flash launches {launches} (want {want} "
            f"each: {CONFIG_125M.num_layers} a step, every one on the tensor cores)")
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"fit's losses are not finite: {losses}")
        if launches != dict.fromkeys(FLASH_LAUNCH_KEYS, want):
            raise AssertionError(f"fit launched flash {launches}, want {want} each")
        rec = ledger.reconcile()
        log(f"[train] fit ledger: reconcile ok={rec['ok']} residual {rec['residual_s']:.2e} s "
            f"of {rec['wall_s']:.3f} s; buckets "
            f"{ {k: round(v, 6) for k, v in rec['buckets'].items()} }; device families "
            f"{ledger.device_families()}")
        if not rec["ok"]:
            raise AssertionError(f"fit's ledger does not reconcile: {rec}")
        # The loop's own cost, apart from the checkpoint writer (whose
        # serialisation overlaps every step after the first save): fit
        # with no checkpoint dir, then the bare step on the same state with
        # a loss read after every step (the loop's sync alone).
        ckpt_rates = [h["seconds_per_step"] for h in hist if "seconds_per_step" in h]
        t_state, t_hist = fit(fit_model(), stream, None, None, fit_config(
            steps=FIT_TIME_STEPS, prefetch=2), registry=MetricsRegistry(), tracer=Tracer(),
            ledger=GoodputLedger(), **kw)
        rates = [h["seconds_per_step"] for h in t_hist if "seconds_per_step" in h]
        logged_mfu = [h["mfu"] for h in t_hist if "mfu" in h]
        bare = make_train_step(**TRAIN_LOSS)
        batch = {k: torch.from_numpy(v).cuda() for k, v in stream.batch(0).items()}
        synced = []
        for _ in range(FIT_TIME_STEPS):
            t0 = time.perf_counter()
            float(bare(t_state, batch)[1])
            synced.append(time.perf_counter() - t0)
        del t_state
        step_s, synced_s = statistics.median(rates), statistics.median(synced[1:])
        timing = dict(ms_per_step=step_s * 1e3, tok_s=TRAIN_B * TRAIN_S / step_s,
                      mfu=mfu(flops, step_s),
                      logger_mfu=statistics.median(logged_mfu) if logged_mfu else None,
                      bare_step_ms=step_ms, synced_step_ms=synced_s * 1e3,
                      host_ms_per_step=step_s * 1e3 - step_ms,
                      sync_ms_per_step=synced_s * 1e3 - step_ms,
                      loop_ms_per_step=(step_s - synced_s) * 1e3, seconds_per_step=rates,
                      with_checkpoints_ms_per_step=statistics.median(ckpt_rates) * 1e3,
                      with_checkpoints_mean_ms_per_step=statistics.mean(ckpt_rates) * 1e3,
                      with_checkpoints_seconds_per_step=ckpt_rates, wall_s=wall)
        log(f"[time] 125M fit b={TRAIN_B} s={TRAIN_S} bf16, flash + fused loss + AdamW, "
            f"MetricsLogger steady {timing['ms_per_step']:.3f} ms/step (median of "
            f"{len(rates)}, no checkpoints), {timing['tok_s']:.1f} tok/s, MFU "
            f"{timing['mfu']:.4f} (the logger's median {timing['logger_mfu']}); [time] 125M "
            f"train step {step_ms:.3f} ms/step: the loop adds {timing['host_ms_per_step']:.3f} "
            f"ms a step, of which the per-step loss read {timing['sync_ms_per_step']:.3f} (the "
            f"bare step read every step: {timing['synced_step_ms']:.3f} ms) and the loader, "
            f"ledger and metrics {timing['loop_ms_per_step']:.3f}; with checkpoints every "
            f"{FIT_CKPT_EVERY} (the writer overlapping the steps after the first save) median "
            f"{timing['with_checkpoints_ms_per_step']:.3f}, mean "
            f"{timing['with_checkpoints_mean_ms_per_step']:.3f} ms/step, {FIT_STEPS} steps in "
            f"{wall:.3f} s; on {card}")
        plan = memory_plan(state.model.config, TRAIN_B, TRAIN_S)
        log(f"[train] fit memory: plan {plan.total / 2**30:.3f} GiB (params "
            f"{plan.params / 2**30:.3f}, grads {plan.grads / 2**30:.3f}, optimizer "
            f"{plan.optimizer_state / 2**30:.3f}, saved activations "
            f"{plan.saved_activations / 2**30:.3f}, loss head {plan.loss_head / 2**30:.3f}), "
            f"torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB; card "
            f"{device_hbm_bytes() / 2**30:.3f} GiB")
        out.update(losses=losses, launches=launches, ledger=rec, timing=timing,
                   memory=dict(plan=dataclasses.asdict(plan), max_allocated=peak,
                               device_bytes=device_hbm_bytes()),
                   registry_steps=registry.get("train_steps_total").value)

        # Checkpoint save and restore, timed; the restore gate.
        saved = {k: v.clone() for k, v in state_tensors(state).items()}
        mb = sum(v.numel() * v.element_size() for v in saved.values()) / 1e6
        with CheckpointManager(os.path.join(tmp, "timed")) as ckpt:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save(FIT_STEPS, state)
            staged = time.perf_counter() - t0
            ckpt.wait()
            written = time.perf_counter() - t0
        del state, model
        torch.cuda.empty_cache()
        fresh = sharded_train_state(fit_model(), adamw(3e-4))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CheckpointManager(os.path.join(tmp, "full")) as ckpt:
            kept = ckpt.all_steps()
            ckpt.restore_latest(like=fresh)
        torch.cuda.synchronize()
        restored_s = time.perf_counter() - t0
        got = state_tensors(fresh)
        unequal = [k for k, v in saved.items() if k not in got or not torch.equal(got[k], v)]
        log(f"[time] checkpoint of the 125M train state ({len(saved)} tensors, {mb:.1f} MB): "
            f"save returns in {staged * 1e3:.3f} ms (the copies queued), on disk in "
            f"{written * 1e3:.3f} ms; restore_latest {restored_s * 1e3:.3f} ms; kept steps "
            f"{kept}; restored step {fresh.step}, {len(saved) - len(unequal)} of {len(saved)} "
            f"tensors bit-equal to the saved ones, on {card}")
        if unequal or fresh.step != FIT_STEPS or kept != [FIT_STEPS - FIT_CKPT_EVERY, FIT_STEPS]:
            raise AssertionError(f"restore: step {fresh.step}, kept {kept}, unequal {unequal[:5]}")
        out["checkpoint"] = dict(mb=mb, save_return_ms=staged * 1e3, save_disk_ms=written * 1e3,
                                 restore_ms=restored_s * 1e3, tensors=len(saved))

        # The descent gate: evaluate the restored state over the batches
        # scored before the run.
        t0 = time.perf_counter()
        ev = evaluate(fresh, stream, None, None, batch_size=TRAIN_B,
                      num_batches=FIT_EVAL_BATCHES, **kw)
        drop = ev0["loss"] - ev["loss"]
        log(f"[train] evaluate over the first {FIT_EVAL_BATCHES} batches: loss {ev0['loss']:.6f} "
            f"before the run, {ev['loss']:.6f} (perplexity {ev['perplexity']:.3f}) after "
            f"{FIT_STEPS} steps: fell {drop:.6f} nats (want at least {FIT_DESCENT_MARGIN}); "
            f"{time.perf_counter() - t0:.3f} s")
        if not math.isfinite(ev["loss"]) or not drop >= FIT_DESCENT_MARGIN:
            raise AssertionError(f"fit did not descend: evaluate's loss {ev0['loss']} -> {ev['loss']}")
        out["evaluate"] = dict(ev, before=ev0["loss"], drop=drop)

        # The guarded step on a poisoned batch.
        batch = {k: torch.from_numpy(v).cuda() for k, v in stream.batch(FIT_STEPS).items()}
        batch["poison"] = torch.ones((TRAIN_B, 1), device="cuda")
        step = make_train_step(loss_fn=poisoned_loss, skip_nonfinite=True, **kw["step_kwargs"])
        before = {k: v.clone() for k, v in state_tensors(fresh).items()}
        counts = (fresh.step, fresh.updates)
        _, res = step(fresh, batch)
        after = state_tensors(fresh)
        moved = [k for k, v in before.items() if not torch.equal(after[k], v)]
        log(f"[train] guarded step on a poisoned batch: loss {float(res['loss'])}, grad norm "
            f"{float(res['grad_norm'])}; {len(before) - len(moved)} of {len(before)} parameters "
            f"and moments bit-equal; step {counts[0]} -> {fresh.step}, updates {counts[1]} -> "
            f"{fresh.updates}")
        if (moved or math.isfinite(float(res["loss"])) or fresh.step != counts[0] + 1
                or fresh.updates != counts[1]):
            raise AssertionError(f"the guard moved {moved[:5]} or miscounted")
        out["guard"] = dict(moved=len(moved), checked=len(before))
        del fresh, before, after, saved, got
        torch.cuda.empty_cache()

        # The resumed run: 8 steps, then a fresh model's fit to 12.
        part = os.path.join(tmp, "part")
        fit(fit_model(), stream, None, None, fit_config(
            steps=FIT_RESUME_AT, checkpoint_dir=part, checkpoint_every=FIT_RESUME_AT,
            max_checkpoints=2), **kw)
        torch.cuda.empty_cache()
        resumed_state, resumed = fit(fit_model(), stream, None, None, fit_config(
            steps=FIT_STEPS, checkpoint_dir=part, checkpoint_every=FIT_RESUME_AT,
            max_checkpoints=2), **kw)
        tail = [h["loss"] for h in resumed]
        ref = losses[FIT_RESUME_AT:]
        bit_equal = tail == ref
        log(f"[train] resumed at {FIT_RESUME_AT}: steps {[h['step'] for h in resumed]}, losses "
            f"{tail} against the uninterrupted {ref} ({'bit-equal' if bit_equal else 'not bit-equal'}"
            f", rtol 1e-6)")
        if [h["step"] for h in resumed] != list(range(FIT_RESUME_AT + 1, FIT_STEPS + 1)):
            raise AssertionError(f"the resumed run took steps {[h['step'] for h in resumed]}")
        np.testing.assert_allclose(tail, ref, rtol=1e-6)
        out["resume"] = dict(losses=tail, reference=ref, bit_equal=bit_equal)
        del resumed_state
        torch.cuda.empty_cache()

        # Lion (with the fused norm: rows 5-6 of the kernel table on a fit
        # path) and adafactor, FIT_OPT_STEPS steps each.
        out["optimizers"] = {}
        for name, fields in (("lion", dict(fused_norm=True)), ("adafactor", {})):
            reset_norm_launches()
            st, h = fit(fit_model(**fields), stream, None, None, fit_config(
                steps=FIT_OPT_STEPS, optimizer=name), **kw)
            torch.cuda.synchronize()
            norm = dict(norm_ops.fused_residual_norm.launches)
            opt_losses = [x["loss"] for x in h]
            rates = [x["seconds_per_step"] for x in h if "seconds_per_step" in x]
            slots = sum(v.numel() for p in st.model.parameters()
                        for k, v in st.optimizer.state[p].items() if k != "step")
            log(f"[train] fit with {name}{' and fused_norm' if fields else ''}, "
                f"{FIT_OPT_STEPS} steps: losses {[round(x, 4) for x in opt_losses]}, "
                f"{statistics.median(rates) * 1e3:.3f} ms/step, {slots / 1e6:.3f} M optimizer "
                f"state elements; fused-norm launches {norm}")
            if not all(map(math.isfinite, opt_losses)):
                raise AssertionError(f"{name}: non-finite losses {opt_losses}")
            if fields:
                per = norm_calls(CONFIG_125M) * FIT_OPT_STEPS
                if norm != {"fwd": per, "fwd_nostats": 0, "bwd": per}:
                    raise AssertionError(f"fused-norm fit launched {norm}, want {per} each")
                out["norm_launches"] = norm
            out["optimizers"][name] = dict(losses=opt_losses, ms_per_step=statistics.median(
                rates) * 1e3, state_elements=slots)
            del st
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# [train] remat: each variant's first make_train_step step from the same
# seeded weights (a stacked model takes them through stack_scan_params),
# held bit for bit to its twin without remat (REMAT_TWIN, else the plain
# step) and within the flash-vs-dense step tolerances to the plain step.
REMAT_VARIANTS = {
    "plain": {},
    "remat": dict(remat=True),
    "remat_dots": dict(remat=True, remat_policy="dots"),
    "remat_dots_no_batch": dict(remat=True, remat_policy="dots_no_batch"),
    "scan_layers": dict(scan_layers=True),
    "fused_norm": dict(fused_norm=True),
    "remat_fused_norm": dict(remat=True, fused_norm=True),
}
REMAT_TWIN = {"remat_fused_norm": "fused_norm"}
REMAT_TIME_STEPS = 4   # the steps each variant is timed over (after two)


def run_remat_path(gen, card):
    """``[train] remat``: the 125M train step (b=8, s=1024, bf16, flash,
    the fused loss, ``make_train_step`` with AdamW) under block remat with
    each policy, with ``scan_layers=True``, with ``fused_norm=True`` and
    with remat + ``fused_norm=True``, each from the plain step's seeded
    weights. Every gate reads each variant's first step, its counters set
    to 0 just before it: the loss and the gradients it leaves on the model
    bit-equal to its twin's (remat and ``scan_layers`` change no kernel and
    no input of one) and within the flash-vs-dense step tolerances of the
    plain step's; the flash launches, forward 24 under block remat (each
    recomputed in the backward), 12 without, dK/dV and dQ 12; the
    fused-norm launches, 25 forwards plus the 24 of the blocks recomputed,
    25 backwards. The second step gives each variant's peak memory above
    what it held before (weights, gradients, AdamW's moments); full remat
    must lower it. Then the ms a step, the variants interleaved."""
    flash_fn = flash.make_flash_attn_fn()
    base_cfg = dataclasses.replace(CONFIG_125M, attn_fn=flash_fn)
    params = Transformer(base_cfg, device="cuda", seed=0).state_dict()
    batch = train_batch(gen, CONFIG_125M.vocab_size)
    layers, calls = CONFIG_125M.num_layers, norm_calls(CONFIG_125M)
    step = make_train_step(**TRAIN_LOSS)
    states, rows, twins = {}, {}, {}
    for name, fields in REMAT_VARIANTS.items():
        cfg = dataclasses.replace(base_cfg, **fields)
        model = Transformer(cfg, device="cuda", seed=0)
        model.load_state_dict(stack_scan_params(params) if cfg.scan_layers else params)
        states[name] = sharded_train_state(model, adamw(3e-4))
        torch.cuda.synchronize()
        flash.flash_attention.launches = dict.fromkeys(flash.flash_attention.launches, 0)
        reset_norm_launches()
        _, loss = step(states[name], batch)
        torch.cuda.synchronize()
        launches = dict(flash=dict(flash.flash_attention.launches),
                        fused_norm=dict(norm_ops.fused_residual_norm.launches))
        grads = {n: p.grad for n, p in model.named_parameters()}
        if cfg.scan_layers:
            grads = unstack_scan_params(grads)
        remat = bool(fields.get("remat"))
        want_flash = {"fwd": 2 * layers if remat else layers, "bwd_dkv": layers,
                      "bwd_dq": layers}
        got_flash = {k: launches["flash"][k] for k in want_flash}
        want_norm = ({"fwd": calls + (calls - 1) * remat, "fwd_nostats": 0, "bwd": calls}
                     if fields.get("fused_norm") else dict.fromkeys(("fwd", "fwd_nostats", "bwd"), 0))
        rows[name] = dict(loss=loss.item(), launches=launches)
        if got_flash != want_flash:
            raise AssertionError(f"{name}: flash launches {got_flash}, want {want_flash}")
        if launches["fused_norm"] != want_norm:
            raise AssertionError(f"{name}: fused-norm launches {launches['fused_norm']}, "
                                 f"want {want_norm}")
        if name == "plain" or name in REMAT_TWIN.values():
            twins[name] = (loss, grads)
        if name == "plain":
            log(f"[train] remat plain: loss {loss.item():.6f}; flash {got_flash}")
            continue
        loss0, grads0 = twins["plain"]
        rel = {n: ((g - grads0[n]).float().norm() / grads0[n].float().norm()).item()
               for n, g in grads.items()}
        worst = max(rel, key=rel.get)
        diff = abs(loss.item() - loss0.item())
        rows[name].update(loss_diff=diff, worst_grad_rel_err=rel[worst], worst_grad=worst)
        twin = REMAT_TWIN.get(name, "plain") if remat or cfg.scan_layers else None
        if twin:
            twin_loss, twin_grads = twins[twin]
            rows[name].update(twin=twin, bit_equal=bool(torch.equal(loss, twin_loss)) and all(
                torch.equal(g, twin_grads[n]) for n, g in grads.items()))
        log(f"[train] remat {name}: loss {loss.item():.6f} vs plain {loss0.item():.6f} (diff "
            f"{diff:.2e}, tol {STEP_LOSS_TOL:g}); worst grad rel Frobenius err {rel[worst]:.3e} "
            f"({worst}, tol {STEP_GRAD_TOL:g}); "
            + (f"bit-equal to {twin}: {rows[name]['bit_equal']}; " if twin else "")
            + f"flash {got_flash}; fused norm {launches['fused_norm']} (want {want_norm})")
        if not diff <= STEP_LOSS_TOL:
            raise AssertionError(f"{name}: loss {loss.item()} vs plain {loss0.item()}")
        if not rel[worst] <= STEP_GRAD_TOL:
            raise AssertionError(f"{name}: grad of {worst} differs by {rel[worst]}")
        if twin and not rows[name]["bit_equal"]:
            raise AssertionError(f"{name}: loss or gradients not bit-equal to {twin}'s step")
        del grads, rel
    del twins, params
    torch.cuda.empty_cache()
    for name, state in states.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(state, batch)
        torch.cuda.synchronize()
        rows[name]["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    peak0 = rows["plain"]["peak_bytes"]
    log("[train] remat peak memory of the second step above what it held before: " + ", ".join(
        f"{name} {row['peak_bytes'] / 2**30:.3f} GiB" for name, row in rows.items()))
    if not rows["remat"]["peak_bytes"] < peak0:
        raise AssertionError(f"full remat's peak {rows['remat']['peak_bytes']} is not below "
                             f"the plain step's {peak0}")
    secs = interleaved_seconds({name: functools.partial(step, st, batch)
                                for name, st in states.items()}, rounds=REMAT_TIME_STEPS)
    for name, s in secs.items():
        rows[name]["ms_per_step"] = statistics.median(s) * 1e3
        rows[name]["step_seconds"] = s
        log(f"[time] 125M train step b={TRAIN_B} s={TRAIN_S} bf16, {name}: "
            f"{rows[name]['ms_per_step']:.3f} ms/step (median of {len(s)}: "
            f"{[round(x, 4) for x in s]} s), peak {rows[name]['peak_bytes'] / 2**30:.3f} GiB "
            f"above the step's start, on {card}")
    del states
    torch.cuda.empty_cache()
    return rows


# [train] precision / zero1 / lora: the 125M train step (b=8, s=1024, flash,
# fused norm, the fused loss) under the optimizer wrappers of slice D.
OPT_STEPS = 8           # the counted call of each phase
OPT_EMA_DECAY = 0.999
OPT_EMA_TOL = 1e-6      # the card's EMA vs a host recompute from the same operands
OPT_ZERO1_RTOL = 1e-3   # the (2, 1) thread-rank losses vs the one-card run's
OPT_ZERO1_SHAPE = (2, 1)
OPT_NEW = 16            # tokens the EMA and merged-LoRA generates add to a 128 prompt
LORA_RANK = 8


def _opt_cfg(**fields):
    """The 125M config of the optimizer phases: flash attention, fused norm."""
    return dataclasses.replace(CONFIG_125M, attn_fn=flash.make_flash_attn_fn(),
                               fused_norm=True, **fields)


def _wrapped_adamw():
    return with_ema(master_weights(adamw(3e-4)), OPT_EMA_DECAY)


def _counted_call(label, call, steps, layers, frozen_norms=0):
    """``call()`` with the flash and fused-norm counters from zero, held to
    ``steps`` train steps' launches → (its result, the launches). The first
    ``frozen_norms`` norms of a step see no input that takes a gradient
    (LoRA's first one: frozen embeddings and norm): a forward without
    statistics and no backward."""
    torch.cuda.synchronize()
    _reset_kernel_launches()
    out = call()
    torch.cuda.synchronize()
    got = {k: v for k, v in _kernel_launches().items()
           if k.startswith(("flash_", "fused_norm_")) and v}
    per = (norm_calls(CONFIG_125M) - frozen_norms) * steps
    want = {**{f"flash_{k}": steps * layers for k in FLASH_LAUNCH_KEYS},
            "fused_norm_fwd": per, "fused_norm_bwd": per}
    if frozen_norms:
        want["fused_norm_fwd_nostats"] = frozen_norms * steps
    log(f"[train] {label}: launches {got} (want {want})")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")
    return out, got


def _step_memory(step, state, batch) -> int:
    """Peak bytes a step allocates above what was held before it
    (activations, gradients and the update's temporaries)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    step(state, batch)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held


def _ema_generate(label, cfg, tree, prompt):
    """A generate (+OPT_NEW) from ``tree`` with decode attention's counters
    from zero, held to ``generate_decode_launches``."""
    fn = make_generate_fn(cfg, max_new_tokens=OPT_NEW)
    torch.cuda.synchronize()
    reset_launches()
    out = fn(tree, prompt)
    torch.cuda.synchronize()
    got = {k: v for k, v in read_launches().items() if k.startswith("decode_attention")
           and k != "decode_attention_paged"}
    want = dict(generate_decode_launches(cfg, b=prompt.shape[0], prompt=prompt.shape[1],
                                         new=OPT_NEW),
                decode_attention=cfg.num_layers * OPT_NEW)
    log(f"[train] {label} generate: decode attention {got} (want {want})")
    if got != want:
        raise AssertionError(f"{label} generate: decode attention launches {got}, want {want}")
    check_output(out, prompt.shape[0], prompt.shape[1] + OPT_NEW, cfg.vocab_size)
    return got


def run_precision_path(gen, card, batch):
    """``[train] precision``: the 125M train step in bf16 parameters under
    ``with_ema(master_weights(adamw(3e-4)))``. One counted ``OPT_STEPS``-step
    call (flash and fused-norm launches as the plain step's, the loss
    falls); one more step, after which every parameter equals JAX's delta
    arithmetic from its fp32 master (``p + (m.to(bf16) − p)`` on the
    parameter before it, bit for bit) and every EMA a host recompute from
    its operands within ``OPT_EMA_TOL``; a generate from ``ema_params``
    (decode attention counted); the ms a step, the peak and the
    optimizer-state bytes against the plain fp32 AdamW step's, interleaved.
    → the row, with the losses ``[train] zero1`` is held to."""
    cfg = _opt_cfg(param_dtype=torch.bfloat16)
    state = sharded_train_state(Transformer(cfg, device="cuda", seed=0), _wrapped_adamw())
    plain = sharded_train_state(Transformer(_opt_cfg(), device="cuda", seed=0), adamw(3e-4))
    stacked = {k: v.expand(OPT_STEPS, *v.shape) for k, v in batch.items()}
    multi = make_train_step(steps_per_call=OPT_STEPS, **TRAIN_LOSS)
    step = make_train_step(**TRAIN_LOSS)
    (_, losses), launches = _counted_call("precision", lambda: multi(state, stacked),
                                          OPT_STEPS, cfg.num_layers)
    losses = losses.tolist()
    log(f"[train] precision: {OPT_STEPS} steps, losses {[round(x, 4) for x in losses]}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"precision: losses {losses}")
    opt = state.optimizer
    named = list(state.model.named_parameters())
    before = {n: p.detach().clone() for n, p in named}
    ema_before = {n: opt.state[p]["ema"].cpu().clone() for n, p in named}
    step(state, batch)
    torch.cuda.synchronize()
    landed = ema_err = 0
    for n, p in named:
        slots = opt.state[p]
        want = before[n] + (slots["master"].to(p.dtype) - before[n])
        landed += bool(torch.equal(p.detach(), want))
        host = ema_before[n] + (1.0 - OPT_EMA_DECAY) * (p.detach().float().cpu() - ema_before[n])
        ema_err = max(ema_err, (slots["ema"].cpu() - host).abs().max().item())
    log(f"[train] precision: {landed} of {len(named)} bf16 parameters equal to JAX's delta "
        f"arithmetic from their masters; EMA vs host recompute max |err| {ema_err:.3e} "
        f"(tol {OPT_EMA_TOL:g})")
    if landed != len(named):
        raise AssertionError(f"precision: {len(named) - landed} parameters off the delta")
    if not ema_err <= OPT_EMA_TOL:
        raise AssertionError(f"precision: EMA off its host recompute by {ema_err}")
    del before, ema_before
    prompt = batch["inputs"][:, :PROMPT]
    ema_launches = _ema_generate("precision EMA", CONFIG_125M, ema_params(state), prompt)
    row = dict(losses=losses, launches=launches, ema_generate_launches=ema_launches,
               params_on_delta=landed, ema_max_abs_err=ema_err, state_bytes=state_bytes(opt),
               count_bytes=sum(opt.state[p]["step"].element_size() for _, p in named))
    multi(plain, stacked)                                       # the plain step's state
    row["plain_state_bytes"] = state_bytes(plain.optimizer)
    row["param_bytes"], row["plain_param_bytes"] = (
        sum(p.numel() * p.element_size() for p in st.model.parameters()) for st in (state, plain))
    row["step_peak_bytes"] = _step_memory(step, state, batch)
    row["plain_step_peak_bytes"] = _step_memory(step, plain, batch)
    secs = interleaved_seconds({"precision": functools.partial(multi, state, stacked),
                                "plain": functools.partial(multi, plain, stacked)})
    row.update({f"{k}_ms_per_step": statistics.median(v) / OPT_STEPS * 1e3
                for k, v in secs.items()}, call_seconds=secs)
    gib = {k: row[k] / 2**30 for k in ("param_bytes", "state_bytes", "step_peak_bytes",
                                      "plain_param_bytes", "plain_state_bytes",
                                      "plain_step_peak_bytes")}
    log(f"[time] 125M train step b={TRAIN_B} s={TRAIN_S}, fused norm: bf16 params under "
        f"with_ema(master_weights(adamw)) {row['precision_ms_per_step']:.3f} ms/step, params "
        f"{gib['param_bytes']:.3f} GiB + optimizer state {gib['state_bytes']:.3f} GiB, a step's "
        f"peak above them {gib['step_peak_bytes']:.3f} GiB; plain fp32 AdamW "
        f"{row['plain_ms_per_step']:.3f} ms/step, {gib['plain_param_bytes']:.3f} + "
        f"{gib['plain_state_bytes']:.3f} GiB, peak above {gib['plain_step_peak_bytes']:.3f} GiB "
        f"(median of 3 {OPT_STEPS}-step calls, interleaved) on {card}")
    del state, plain
    torch.cuda.empty_cache()
    return row


def _zero1_rank(mesh, batch):
    """A rank of ``[train] zero1``: the precision phase's state under ZeRO-1
    over ``data`` → (losses of one counted call, this rank's optimizer-state
    bytes, the call's seconds, its peak bytes)."""
    from learning_jax_sharding_tpu_torch.parallel import logical

    rules = logical.RULES_DP_TP
    cfg = dataclasses.replace(CONFIG_125M, attn_fn=flash.make_flash_attn_fn(mesh, rules),
                              fused_norm=True, param_dtype=torch.bfloat16)
    state = sharded_train_state(Transformer(cfg, device="cuda", seed=0), _wrapped_adamw(),
                                mesh=mesh, rules=rules, zero1_axis="data")
    multi = make_train_step(steps_per_call=OPT_STEPS, mesh=mesh, rules=rules, **TRAIN_LOSS)
    stacked = {k: v.expand(OPT_STEPS, *v.shape) for k, v in batch.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, losses = multi(state, stacked)
    torch.cuda.synchronize()
    return losses.tolist(), state_bytes(state.optimizer), time.perf_counter() - t0


def run_zero1_path(card, batch, one_card):
    """``[train] zero1``: the precision phase's steps on a (2, 1) data mesh
    of thread ranks (NCCL refuses two ranks on one card), the optimizer
    state ZeRO-1 split over data: the losses within ``OPT_ZERO1_RTOL`` of
    the one-card run's, each rank's optimizer-state bytes half of it (the
    scalar step counts aside), the two ranks' flash and fused-norm
    launches those of 2 × ``OPT_STEPS`` steps."""
    from learning_jax_sharding_tpu_torch.parallel import run_on_threads

    ranks = math.prod(OPT_ZERO1_SHAPE)
    (losses, nbytes, seconds), launches = _counted_call(
        f"zero1 ({ranks} thread ranks)",
        lambda: run_on_threads(_zero1_rank, OPT_ZERO1_SHAPE, ("data", "model"),
                               device_type="cuda", args=(batch,)),
        ranks * OPT_STEPS, CONFIG_125M.num_layers)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, one_card["losses"]))
    scalars = one_card["count_bytes"]
    half = (nbytes - scalars) * 2 == one_card["state_bytes"] - scalars
    log(f"[train] zero1: losses {[round(x, 4) for x in losses]} vs one card "
        f"{[round(x, 4) for x in one_card['losses']]}, max rel diff {rel:.2e} (limit "
        f"{OPT_ZERO1_RTOL:g}); rank 0's optimizer state {nbytes / 2**30:.4f} GiB vs one card "
        f"{one_card['state_bytes'] / 2**30:.4f} GiB (half: {half}); {seconds:.1f} s for "
        f"{OPT_STEPS} steps ({seconds / OPT_STEPS * 1e3:.1f} ms/step, the ranks taking turns "
        f"on one card and one interpreter) on {card}")
    if not rel <= OPT_ZERO1_RTOL:
        raise AssertionError(f"zero1: losses {losses} vs {one_card['losses']}")
    if not half:
        raise AssertionError(f"zero1: {nbytes} bytes a rank, one card {one_card['state_bytes']}")
    return dict(losses=losses, max_rel_diff=rel, state_bytes=nbytes, launches=launches,
                call_seconds=seconds, ms_per_step=seconds / OPT_STEPS * 1e3, ranks=ranks)


def run_lora_path(gen, card, batch):
    """``[train] lora``: rank-8 adapters over the frozen 125M base (fp32
    weights, flash, fused norm, the fused loss) under ``adamw(3e-4)``: one
    counted step whose loss is the base step's bit for bit (B starts at 0),
    then ``OPT_STEPS - 1`` more; the base bit-unchanged; a generate from
    ``merge_lora``'s tree (decode attention counted); the ms a step, the
    peak and the adapters' optimizer-state bytes."""
    cfg = _opt_cfg()
    model = Transformer(cfg, device="cuda", seed=0)
    base = {n: p.detach() for n, p in model.named_parameters()}
    before = {n: t.clone() for n, t in base.items()}
    lgen = torch.Generator(device="cuda").manual_seed(LORA_RANK)
    ls = lora_train_state(lgen, base, adamw(3e-4), LORA_RANK)
    step = make_lora_train_step(model, adamw(3e-4), **TRAIN_LOSS)
    with torch.enable_grad():
        hidden = model(batch["inputs"], return_hidden=True)
        base_loss = TRAIN_LOSS["loss_fn"](hidden, batch, model).detach()
    del hidden
    (ls, first), launches = _counted_call("lora", lambda: step(base, ls, batch), 1,
                                          cfg.num_layers, frozen_norms=1)
    losses = [first]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for _ in range(OPT_STEPS - 1):
        ls, loss = step(base, ls, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    losses = [x.item() for x in losses]
    unchanged = all(torch.equal(base[n], t) for n, t in before.items())
    log(f"[train] lora rank {LORA_RANK}: step 0 loss {losses[0]!r} vs the base's "
        f"{base_loss.item()!r} (bit-equal: {bool(torch.equal(first, base_loss))}); losses "
        f"{[round(x, 4) for x in losses]}; base unchanged: {unchanged}")
    if not torch.equal(first, base_loss):
        raise AssertionError(f"lora: step 0 loss {first} vs base {base_loss}")
    if not unchanged or not losses[-1] < losses[0]:
        raise AssertionError(f"lora: base unchanged {unchanged}, losses {losses}")
    del before
    merged = {n: t.detach() for n, t in merge_lora(base, ls).items()}
    gen_launches = _ema_generate("lora merged", CONFIG_125M, merged, batch["inputs"][:, :PROMPT])
    row = dict(losses=losses, launches=launches, generate_launches=gen_launches,
               ms_per_step=seconds / (OPT_STEPS - 1) * 1e3, peak_bytes=peak,
               state_bytes=state_bytes(ls.opt_state),
               adapter_params=sum(t.numel() for ab in ls.adapters.values() for t in ab.values()))
    log(f"[time] 125M LoRA rank {LORA_RANK} step b={TRAIN_B} s={TRAIN_S}: "
        f"{row['ms_per_step']:.3f} ms/step ({OPT_STEPS - 1} steps), a step's peak above "
        f"what was held {peak / 2**30:.3f} GiB, adapters {row['adapter_params']} parameters, optimizer "
        f"state {row['state_bytes'] / 2**20:.2f} MiB on {card}")
    del ls, merged, model, base
    torch.cuda.empty_cache()
    return row


# [beam]: GPT-2 small's published GPT2Config (the "gpt2" checkpoint's
# fields), weights seeded and tied, B=2 rows of a 64-token prompt, +32.
GPT2_SMALL = dict(n_layer=12, n_embd=768, n_head=12, vocab_size=50257, n_positions=1024,
                  layer_norm_epsilon=1e-5, activation_function="gelu_new", n_inner=None)
BEAM_B, BEAM_K, BEAM_PROMPT, BEAM_NEW = 2, 4, 64, 32
BEAM_SCORE_TOL = 1e-3   # fp32: the blocked vs dense scores; the score vs a dense forward's


def beam_decode_launches(cfg, dtype) -> dict:
    """Decode attention's launches in one search as the wrapper's rules give
    them: the prefill's (B rows of the prompt) and every token step's (B·K
    rows), a layer each."""
    layers, n, h = cfg.num_layers, cfg.num_heads, cfg.head_dim
    prefill = da._plan(dtype, BEAM_B, BEAM_PROMPT, n, n, h, cfg.max_seq_len)[:2]
    step = da._plan(dtype, BEAM_B * BEAM_K, 1, n, n, h, cfg.max_seq_len)[:2]
    steps = BEAM_NEW - 1
    return {"decode_attention": layers * (1 + steps),
            "decode_attention_tensor_core": layers * ((prefill[0] == "tensor_core")
                                                      + steps * (step[0] == "tensor_core")),
            "decode_attention_split": layers * ((prefill[1] > 1) + steps * (step[1] > 1)),
            "designs": {"prefill": f"{prefill[0]}/{prefill[1]}", "step": f"{step[0]}/{step[1]}"}}


def counted_search(search, params, prompt, label, dtype, cfg):
    """One search with decode attention's counters from zero, held to
    ``beam_decode_launches`` → (tokens, scores, launches)."""
    torch.cuda.synchronize()
    reset_launches()
    out, scores = search(params, prompt)
    torch.cuda.synchronize()
    got = {k: v for k, v in read_launches().items() if k.startswith("decode_attention")
           and k != "decode_attention_paged"}
    want = beam_decode_launches(cfg, dtype)
    designs = want.pop("designs")
    log(f"[beam] {label}: decode attention {got} (want {want}: {cfg.num_layers} a model "
        f"call, prefill {designs['prefill']}, token steps {designs['step']})")
    if got != want:
        raise AssertionError(f"{label}: decode attention launches {got}, want {want}")
    check_output(out, BEAM_B, BEAM_PROMPT + BEAM_NEW, cfg.vocab_size)
    if not torch.isfinite(scores).all():
        raise AssertionError(f"{label}: scores {scores}")
    return out, scores, dict(got, **designs)


def run_beam_path(gen, card):
    """``[beam]``: beam search (``models/beam.py``) at the full width of
    GPT-2 small, its config from ``config_from_hf_gpt2`` on the published
    fields, seeded weights carried through ``state_dict_from_params`` →
    ``params_from_hf_gpt2`` (bit-equal). Decode attention at the search's
    prefill and token-step shapes against its plain version. fp32: beam 1
    gives ``make_generate_fn``'s greedy tokens; beam 4 gives the same tokens
    and scores on the blocked and the dense backend; the blocked search's
    scores equal the mean log-probability of its tokens under a dense
    forward. Each counted search launches decode attention once a layer a
    model call on the designs the rules give. bf16: one search timed (tok/s
    of the returned hypotheses and of all beams) and profiled (idle
    share)."""
    hf_config = types.SimpleNamespace(**GPT2_SMALL)
    cfg = config_from_hf_gpt2(hf_config)
    params = Transformer(cfg, device="cuda", seed=0).state_dict()
    params["lm_head.weight"] = params["tok_embed.weight"].clone()   # GPT-2 ties its head
    hf_sd = state_dict_from_params(params)
    back = params_from_hf_gpt2(types.SimpleNamespace(state_dict=lambda: hf_sd,
                                                     config=hf_config))
    unequal = [n for n, t in params.items() if not torch.equal(t.cpu(), back[n])]
    log(f"[beam] GPT-2 small ({cfg.num_layers} x {cfg.features}, vocab {cfg.vocab_size}): "
        f"{len(hf_sd)} HF tensors; round trip of {len(params)} tensors, {len(unequal)} unequal")
    if unequal or set(back) != set(params):
        raise AssertionError(f"HF round trip changed {unequal or set(back) ^ set(params)}")
    params = {n: t.to("cuda") for n, t in back.items()}
    del hf_sd, back
    n, h, length = cfg.num_heads, cfg.head_dim, cfg.max_seq_len
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[str(dtype)[6:]] = max(
            kernel_case("beam_prefill", gen, dtype, b=BEAM_B, s=BEAM_PROMPT, n=n, n_kv=n, h=h,
                        length=length, index=zero),
            kernel_case("beam_step", gen, dtype, b=BEAM_B * BEAM_K, s=1, n=n, n_kv=n, h=h,
                        length=length, index=zero + BEAM_PROMPT + BEAM_NEW // 2))
    prompt = torch.randint(0, cfg.vocab_size, (BEAM_B, BEAM_PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    greedy = make_generate_fn(cfg, max_new_tokens=BEAM_NEW)(params, prompt)
    beam1, _, launches1 = counted_search(
        make_beam_search_fn(cfg, beam_size=1, max_new_tokens=BEAM_NEW), params, prompt,
        "fp32 beam 1", torch.float32, cfg)
    if not torch.equal(beam1, greedy):
        raise AssertionError("beam 1 differs from greedy generate")
    runs = {}
    for backend in ("blocked", "dense"):
        search = make_beam_search_fn(dataclasses.replace(cfg, decode_attention=backend),
                                     beam_size=BEAM_K, max_new_tokens=BEAM_NEW)
        if backend == "blocked":
            runs[backend] = counted_search(search, params, prompt, "fp32 beam 4 blocked",
                                           torch.float32, cfg)
        else:
            runs[backend] = search(params, prompt)
    (tok_b, sc_b, launches4), (tok_d, sc_d) = runs["blocked"], runs["dense"]
    score_diff = (sc_b - sc_d).abs().max().item()
    log(f"[beam] fp32 beam 4, blocked vs dense: tokens equal {torch.equal(tok_b, tok_d)}, "
        f"scores {sc_b.tolist()} vs {sc_d.tolist()} (max diff {score_diff:.2e}, tol "
        f"{BEAM_SCORE_TOL:g})")
    if not torch.equal(tok_b, tok_d) or not score_diff <= BEAM_SCORE_TOL:
        raise AssertionError("beam 4: the blocked and dense backends differ")
    model = Transformer(cfg, device="cuda").eval()
    model.load_state_dict(params)
    with torch.no_grad():
        logp = torch.log_softmax(model(tok_b[:, :-1]).float(), dim=-1)
    picked = logp.gather(-1, tok_b[:, 1:].long()[..., None])[..., 0]
    forward = picked[:, BEAM_PROMPT - 1:].sum(1) / BEAM_NEW
    forward_diff = (forward - sc_b).abs().max().item()
    log(f"[beam] fp32 beam 4 scores vs a dense forward's mean log-probability: max diff "
        f"{forward_diff:.2e} (tol {BEAM_SCORE_TOL:g})")
    if not forward_diff <= BEAM_SCORE_TOL:
        raise AssertionError(f"beam 4 scores differ from the forward's by {forward_diff}")
    del model, logp

    bf16 = make_beam_search_fn(cfg, beam_size=BEAM_K, max_new_tokens=BEAM_NEW,
                               inference_dtype=torch.bfloat16)
    _, _, launches_bf16 = counted_search(bf16, params, prompt, "bf16 beam 4", torch.bfloat16, cfg)
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bf16(params, prompt)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    sec = statistics.median(secs)
    row = dict(tok_s=BEAM_B * BEAM_NEW / sec, beam_tok_s=BEAM_B * BEAM_K * BEAM_NEW / sec,
               ms_per_model_call=sec / BEAM_NEW * 1e3, search_seconds=secs)
    log(f"[time] GPT-2 small beam search b={BEAM_B} k={BEAM_K} prompt {BEAM_PROMPT} "
        f"+{BEAM_NEW} bf16: {row['tok_s']:.1f} tok/s of hypotheses, {row['beam_tok_s']:.1f} of "
        f"beams, {row['ms_per_model_call']:.3f} ms a model call (median of 3: "
        f"{[round(s, 4) for s in secs]} s) on {card}")
    row["profile"] = profile_summary("GPT-2 small beam search model call",
                                     lambda: bf16(params, prompt), BEAM_NEW,
                                     row["ms_per_model_call"])
    del params
    torch.cuda.empty_cache()
    return dict(row, max_abs_err=errs, launches={"fp32 beam 1": launches1,
                                                 "fp32 beam 4 blocked": launches4,
                                                 "bf16 beam 4": launches_bf16},
                blocked_vs_dense_score_diff=score_diff, score_vs_forward_diff=forward_diff)


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


def run_fused_generate_1p4b(card):
    """The launch audit's 1.4B generate (``AUDIT.CONFIG_1P4B``, b=8, 64 +
    64, bf16 weights from a seed) with ``fused_norm=True``: 2048 features, a
    width the first design refused. Every norm through the no-statistics
    forward, counted from zero around one call (49 a model call);
    teacher-forced against the fused-norm dense bf16 forward on the same
    weights (and, reported, the plain-norm one); timed interleaved with the
    plain-norm 1.4B generate (medians of 3)."""
    plain_cfg = AUDIT.CONFIG_1P4B
    cfg = dataclasses.replace(plain_cfg, fused_norm=True)
    params = Transformer(plain_cfg, device="cuda", seed=0).state_dict()
    tree = {k: AUDIT.to_bf16(v) for k, v in params.items()}
    del params
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (AUDIT.B, AUDIT.PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    fns = {name: make_generate_fn(c, max_new_tokens=AUDIT.NEW, inference_dtype=torch.bfloat16)
           for name, c in (("plain_norm", plain_cfg), ("fused_norm", cfg))}
    for fn in fns.values():
        fn(tree, prompt)                                    # warm-up
    torch.cuda.synchronize()
    reset_norm_launches()
    out = fns["fused_norm"](tree, prompt)
    torch.cuda.synchronize()
    norm = dict(norm_ops.fused_residual_norm.launches)
    want = {"fwd": 0, "fwd_nostats": norm_calls(cfg) * AUDIT.NEW, "bwd": 0}
    log(f"[main] 1.4B generate, fused_norm, b={AUDIT.B} prompt {AUDIT.PROMPT} +{AUDIT.NEW}: "
        f"fused-norm launches {norm} (want {want})")
    if norm != want:
        raise AssertionError(f"1.4B fused-norm generate launched {norm}, want {want}")
    total = AUDIT.PROMPT + AUDIT.NEW
    check_output(out, AUDIT.B, total, cfg.vocab_size)
    span = ([AUDIT.PROMPT] * AUDIT.B, [total] * AUDIT.B)
    gaps = {}
    for name, c in (("fused_norm", cfg), ("plain_norm", plain_cfg)):
        model = Transformer(dataclasses.replace(c, param_dtype=torch.bfloat16), device="cuda",
                            seed=1).eval()
        model.load_state_dict(tree)
        gaps[name] = teacher_forced_gap(model, out, *span)
        del model
        torch.cuda.empty_cache()
    log(f"[main] 1.4B fused_norm teacher-forced max gap {gaps['fused_norm']:.4f} (limit "
        f"{TF_GAP}) against the fused-norm dense bf16 forward on the same weights; "
        f"{gaps['plain_norm']:.4f} against the plain-norm one (reported)")
    if not gaps["fused_norm"] <= TF_GAP:
        raise AssertionError(f"1.4B fused-norm teacher-forced gap {gaps['fused_norm']} > {TF_GAP}")
    secs = interleaved_seconds({name: functools.partial(fn, tree, prompt)
                                for name, fn in fns.items()})
    timing = {}
    for name, calls in secs.items():
        sec = statistics.median(calls)
        timing[name] = dict(tok_s=AUDIT.B * AUDIT.NEW / sec,
                            ms_per_token_step=sec / AUDIT.NEW * 1e3, seconds=calls)
        log(f"[time] 1.4B generate bf16 b={AUDIT.B} prompt {AUDIT.PROMPT} +{AUDIT.NEW}, {name} "
            f"(interleaved): {timing[name]['tok_s']:.1f} tok/s, "
            f"{timing[name]['ms_per_token_step']:.3f} ms/token-step (median of 3: "
            f"{[round(x, 4) for x in calls]} s) on {card}")
    del fns, tree
    torch.cuda.empty_cache()
    return dict(launches=norm, teacher_forced_max_gap=gaps["fused_norm"],
                plain_norm_tf_gap=gaps["plain_norm"], timing=timing)


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


def time_shape(gen, name, *, s, index, card, n=12, h=64, length=1024, b=B):
    """Decode attention at one generate shape (by default b=8 and 12 heads;
    H=64, bf16 1024-slot caches, one index), queued (device time): the
    public call, the first design on the same inputs, the split sweep, the
    plain version, SDPA on the valid prefix (causal for a chunk) and the
    bound (bytes: the valid K/V prefix, q and out)."""
    dtype = torch.bfloat16
    q = randn(gen, b, s, n, h, dtype=dtype)
    kc = randn(gen, b, n, length, h, dtype=dtype)
    vc = randn(gen, b, n, length, h, dtype=dtype)
    idx = torch.full((), index, dtype=torch.int32, device="cuda")
    row, late = time_designs((q, kc, vc, idx), {}, (b, s, n, n, h, length))
    valid = index + s
    qt, kt, vt = q.transpose(1, 2).contiguous(), kc[:, :, :valid], vc[:, :, :valid]
    library_ms, _ = queued_time(torch.nn.functional.scaled_dot_product_attention, qt, kt, vt,
                                is_causal=s > 1)
    itemsize = q.element_size()
    nbytes = 2 * q.numel() * itemsize + 2 * b * n * valid * h * itemsize
    pairs = s * index + s * (s + 1) // 2        # (query, key) pairs per (b, head)
    ops = 4 * h * pairs * b * n
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
    beta as the models run it, bf16 rows: the forward with and without the
    residual at the 125M train rows (statistics written, fp32 gamma), at
    its prefill and decode rows and at the 1.4B width's decode and prefill
    rows (no statistics, bf16 gamma, as generation runs it); the backward at
    the train rows without and with ``dr``. Each in the public design and,
    where it takes the width, the first (``warp_row``) on the same inputs,
    beside the plain version, the bound (bytes at the card's memory rate;
    each input read once, each output written once) and the library
    yardstick: ``F.layer_norm`` of ``x + resid`` (the add included), and its
    autograd backward, with gamma and beta cast to bf16 beforehand
    (``F.layer_norm`` takes one dtype)."""
    bf16 = torch.bfloat16
    ln = torch.nn.functional.layer_norm
    fp32_rate = 67e12                 # fp32 outside the tensor cores (H100 SXM)
    rows_out = {}

    def record(key, launch, plain, library, nbytes, ops, m):
        ms, late = queued_time(launch)
        warp_ms, warp_late = (queued_time(launch, design="warp_row")
                              if m <= norm_ops.WARP_ROW_MAX_FEATURES else (None, 0))
        plain_ms, plain_late = queued_time(plain, inner=3, repeats=5)
        lib_ms, lib_late = queued_time(library)
        bound_ms, by = bound(nbytes, ops, fp32_rate)
        row = dict(ms=ms * 1e3, warp_row_ms=None if warp_ms is None else warp_ms * 1e3,
                   plain_ms=plain_ms * 1e3, library_ms=lib_ms * 1e3, bound_ms=bound_ms,
                   bound_by=by, bytes=nbytes, ops=ops,
                   late_samples=late + warp_late + plain_late + lib_late)
        rows_out[key] = row
        log(f"[time] fused_norm {key} bf16: kernel {row['ms'] * 1e3:.2f} us"
            + (f" (warp_row {row['warp_row_ms'] * 1e3:.2f})" if warp_ms is not None else "")
            + f", bound {bound_ms * 1e3:.2f} us ({by}), plain {row['plain_ms'] * 1e3:.2f} us, "
            f"F.layer_norm {row['library_ms'] * 1e3:.2f} us"
            + (f" ({row['late_samples']} samples enqueued past the sleep)"
               if row["late_samples"] else ""))

    shapes = [(NORM_ROWS[name], 768) for name in ("train", "prefill", "decode")]
    shapes += [(rows, 2048) for rows in (AUDIT.B, AUDIT.B * AUDIT.PROMPT)]
    shapes += [(WIDE_NORM_ROWS, WIDE_NORM_WIDTH)]   # the wide kernels
    for rows, m in shapes:
        stats = rows == NORM_ROWS["train"]
        param_dtype = torch.float32 if stats else bf16
        pbytes = 2 * m * (4 if stats else 2)
        for resid in (True, False):
            t = norm_inputs(gen, rows, bf16, param_dtype, resid, True, m)
            x, res, g, b = t["x"], t["res"], t["g"], t["b"]
            g16, b16 = g.to(bf16), b.to(bf16)
            kw = dict(eps=1e-6, kind="layernorm", needs_stats=stats)
            tensors = (4 if resid else 2) * rows * m * 2
            record(f"fwd{' +resid' if resid else ''} {rows}x{m}{' stats' if stats else ''}",
                   lambda design=None: norm_ops._launch_fwd(x, res, g, b, **kw, design=design),
                   lambda: norm_ops.fused_residual_norm_reference(x, res, g, b, **kw),
                   (lambda: ln(x + res, (m,), g16, b16)) if resid else
                   (lambda: ln(x, (m,), g16, b16)),
                   tensors + pbytes + (8 * rows if stats else 0), 10 * rows * m, m)
    rows, m = NORM_ROWS["train"], 768
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
        record(f"bwd{' +dr' if dr is not None else ''} {rows}x{m}",
               lambda design=None: norm_ops._launch_bwd(*args, **kw, design=design),
               lambda: norm_ops.fused_residual_norm_bwd_reference(*args, **kw),
               lambda: torch.autograd.grad(lib_out, (s, g, b), t["dy"], retain_graph=True),
               tensors + 8 * rows + 3 * m * 4, 14 * rows * m, m)
    # The wide backward (past one pass: two column slices).
    rows_w, m_w = WIDE_NORM_ROWS, WIDE_NORM_WIDTH
    tw = norm_inputs(gen, rows_w, bf16, torch.float32, True, True, m_w)
    _, rw, mean_w, rstd_w = norm_ops.fused_residual_norm_reference(
        tw["x"], tw["res"], tw["g"], tw["b"], eps=1e-6, kind="layernorm", needs_stats=True)
    sw = rw.detach().clone().requires_grad_()
    gw, bw = (p.detach().to(bf16).requires_grad_() for p in (tw["g"], tw["b"]))
    lib_w = ln(sw, (m_w,), gw, bw)
    wide_args = (tw["dy"], rw, tw["g"], mean_w, rstd_w, None)
    record(f"bwd {rows_w}x{m_w}",
           lambda design=None: norm_ops._launch_bwd(*wide_args, kind="layernorm", has_beta=True,
                                                    design=design),
           lambda: norm_ops.fused_residual_norm_bwd_reference(*wide_args, kind="layernorm",
                                                              has_beta=True),
           lambda: torch.autograd.grad(lib_w, (sw, gw, bw), tw["dy"], retain_graph=True),
           3 * rows_w * m_w * 2 + 8 * rows_w + 3 * m_w * 4, 14 * rows_w * m_w, m_w)
    # The public geometry against its neighbours on the same train-row
    # inputs: the backward at 1-5 row groups a block, the forward at 1, 2
    # and 4 loads a thread (a row over 3, 2 and 1 warps).
    Design = norm_ops.Design
    geometry = {"fwd": {}, "bwd": {}}
    for dr in (None, t["dr"]):
        for groups in range(1, 6):
            d = Design(8, 1, 96, groups)
            geometry["bwd"][f"{'+dr ' if dr is not None else ''}{d}"] = queued_time(
                lambda: norm_ops._launch_bwd(t["dy"], r, t["g"], mean, rstd, dr,
                                             kind="layernorm", has_beta=True, design=d))[0] * 1e3
    for resid in (True, False):
        res = t["res"] if resid else None
        for vectors, threads in ((1, 96), (2, 64), (4, 32)):
            d = Design(8, vectors, threads, 1)
            geometry["fwd"][f"{'+resid ' if resid else ''}{d}"] = queued_time(
                lambda: norm_ops._launch_fwd(t["x"], res, t["g"], t["b"], eps=1e-6,
                                             kind="layernorm", needs_stats=True,
                                             design=d))[0] * 1e3
    log(f"[time] fused_norm geometry at {rows}x{m} bf16, us: "
        + "; ".join(f"{k} {name}: {v * 1e3:.2f}" for k, g in geometry.items()
                    for name, v in g.items()))
    log(f"[time] fused_norm kernels measured on {card}")
    return rows_out | {"geometry": geometry}


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


def time_paged(gen, card, n=12, shapes=("decode", "prefill")):
    """Decode attention over page pools at the engine's token-step shape
    (b=8, S=1, rows at 544-575, 64-slot pages) and refill shape (S=64 at
    512), bf16, queued (device time): the public call, the first design
    and the split sweep on the pools, the public call on a contiguous cache
    of the same values, the plain paged version, the bound (bytes: each
    row's valid K/V prefix read once, q, out, the index and the table) and
    SDPA on the same bf16 values (each row's valid prefix as a boolean
    mask) as the yardstick. ``n`` heads (12, or a shard's); ``shapes``: the
    ones to time."""
    h, page, t_cap = 64, 64, 16
    length = page * t_cap
    n_pages = 1 + B * t_cap
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, s, lo, hi in (("decode", 1, 544, 576), ("prefill", PAGED_CHUNK, 512, 513)):
        if name not in shapes:
            continue
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
    timed interleaved (``ENGINE_TIME_ROUNDS`` rounds) and one warm paged
    serve profiled."""
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
    secs = interleaved_seconds(calls, ENGINE_TIME_ROUNDS)
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
            f"generated tok/s, {sec:.3f} s per serve (median of {ENGINE_TIME_ROUNDS}: "
            f"{[round(t, 4) for t in times]}); TTFT p50 {timing[label]['ttft_p50'] * 1e3:.1f} "
            f"ms, refill {timing[label]['refill_frac']:.3f} of dispatch time (medians over the "
            f"{ENGINE_TIME_ROUNDS} serves), page high-water {timing[label]['page_high_water']} "
            f"on {card}")
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
                int4_profiles=int4_profiles, ref_outs=runs["unpaged"]["outs"][:B],
                paged_launches=runs["paged+prefix warm"]["launches"]["decode_attention_paged"])


# The engine's decoding modes on the same queue: bench.py's mixed budget
# (two refill chunks beside the decode wave), its self-draft speculation,
# and sampling through top-k 50 and top-p 0.95 at temperature 0.8.
MODES_BUDGET = 2 * PAGED_CHUNK + B
MODES_DRAFT = 4
# Rounds a speculative decode block: 8 rounds of up to 5 tokens cover a
# request's 32. At ENGINE_COMMON's 32 the block runs 32 rounds a wave of
# which about 7 emit (each 5 draft calls and a verify), and the phase
# outgrows its time.
MODES_SPEC_ROUNDS = 8
MODES_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
MODES_SEED = 0
VERIFY_INDEX = 560   # a verify chunk's index inside the engine's range (544-576)


def modes_variants(cfg):
    """The ``[engine] modes`` engines: name → engine arguments."""
    spec = dict(draft_config=cfg, num_draft=MODES_DRAFT, decode_block_steps=MODES_SPEC_ROUNDS)
    paged = dict(paged_pages=ENGINE_PAGES, page_size=ENGINE_PAGE, prefix_cache=True)
    return {
        "split": {},
        "mixed": dict(mixed=True, token_budget=MODES_BUDGET),
        "mixed+horizon 4": dict(mixed=True, token_budget=MODES_BUDGET, horizon=4),
        "self-draft spec": spec,
        "self-draft spec+paged+prefix": dict(spec, **paged),
        "sampled": dict(MODES_SAMPLING),
        "sampled self-draft spec": dict(MODES_SAMPLING, **spec),
    }


def attention_kernel(design, rows, splits) -> str:
    """The kernel of ``csrc/decode_attention.cu`` a launch runs: the
    tensor-core design, or on the CUDA cores the rows kernel (a split launch
    of at most ``kRowsMax`` = 4 folded rows) or the first design."""
    if design == "tensor_core":
        return "tensor_core"
    return "cuda_core rows kernel" if splits > 1 and rows <= 4 else "cuda_core first design"


def first_difference_gaps(model, outs, refs, start, score=None):
    """For each request whose generated tokens differ from ``refs``'s, the
    gap at the FIRST differing position between the two tokens' scores:
    the dense forward's logits there (both sequences share the prefix), or
    ``score(request, position, logits)`` (a sampled draw's Gumbel-perturbed
    scores). → {request: gap}."""
    gaps = {}
    for i, (a, r) in enumerate(zip(outs, refs)):
        diff = np.nonzero(a[start:] != r[start:])[0]
        if not diff.size:
            continue
        pos = start + int(diff[0])
        with torch.no_grad():
            logits = model(torch.as_tensor(a[None, :pos], device="cuda"))[0, -1].float()
        s = logits if score is None else score(i, pos - start, logits)
        gaps[i] = abs(float(s[int(a[pos])]) - float(s[int(r[pos])]))
    return gaps


def support_check(model, outs, start):
    """Sampled tokens against the dense forward's filtered support (top-k
    50, top-p 0.95 at temperature 0.8) at their positions → (tokens, tokens
    outside the strict support, largest shortfall of a token's logit below
    the smallest kept logit)."""
    from learning_jax_sharding_tpu_torch.models.generate import filtered_logits

    total = outside = 0
    worst = 0.0
    for i in range(0, len(outs), B):
        batch = torch.as_tensor(np.stack(outs[i:i + B]), device="cuda")
        with torch.no_grad():
            logits = model(batch).float()[:, start - 1:-1]
        kept = torch.isfinite(filtered_logits(logits, **MODES_SAMPLING))
        toks = batch[:, start:].long()
        chosen = logits.gather(-1, toks[..., None])[..., 0]
        floor = torch.where(kept, logits, torch.inf).amin(-1)
        total += toks.numel()
        outside += int((~kept.gather(-1, toks[..., None])[..., 0]).sum())
        worst = max(worst, float((floor - chosen).clamp(min=0).max()))
    return total, outside, worst


def run_engine_modes(params, gen, card):
    """``[engine] modes``: the engine's decoding modes on
    ``bench.py::bench_serving_125m``'s queue (``ENGINE_COMMON``): the split
    engine, mixed (token budget 136), mixed at horizon 4, self-draft
    speculation (4 proposals a round) unpaged and paged with the prefix
    cache, and sampling (temperature 0.8, top-k 50, top-p 0.95, key 0),
    split and speculative; the speculative engines in decode blocks of
    ``MODES_SPEC_ROUNDS`` rounds. First decode attention at the verify chunk's
    shape (8, 5, 12, 12, 64) against its plain version, timed beside the
    token step. Gates: every greedy variant's requests teacher-forced
    within 0.1 of a dense forward; the horizon's first difference from the
    mixed engine's tokens, where any, a near tie (dense logits within 0.1);
    one host sync a horizon (``torch.cuda.set_sync_debug_mode``); every
    sampled token in the dense forward's filtered support (within 0.1 of
    its smallest logit); the sampled queue admitted in reverse order under
    the same ids gives the same tokens (the split engine's first
    difference, where any, a near tie of the Gumbel-perturbed scores within
    0.1); decode attention launched once a layer per model call, a
    speculative round ``num_draft + 1`` draft calls and one verify call.
    Then every variant's serve timed interleaved (``ENGINE_TIME_ROUNDS``
    rounds) and one wave of each mode profiled per model call."""
    import warnings

    from learning_jax_sharding_tpu_torch.models.generate import filtered_logits
    from learning_jax_sharding_tpu_torch.utils import prng

    cfg = dataclasses.replace(CONFIG_125M, decode_attention="blocked")
    prompts = engine_prompts()
    start = ENGINE_SYSTEM + ENGINE_OWN

    # The verify chunk's shape, against the plain version and timed.
    row_index = torch.randint(start, cfg.max_seq_len - MODES_DRAFT - 1, (B,), generator=gen,
                              device="cuda", dtype=torch.int32)
    verify_errs = {str(dtype)[6:]: kernel_case(
        "verify chunk (8, 5, 12, 12, 64)", gen, dtype, b=B, s=MODES_DRAFT + 1, n=12, n_kv=12,
        h=64, length=cfg.max_seq_len, index=row_index) for dtype in (torch.float32,
                                                                     torch.bfloat16)}
    verify_time = time_shape(gen, "verify chunk", s=MODES_DRAFT + 1, index=VERIFY_INDEX,
                             card=card)
    token_time = time_shape(gen, "token step at the verify index", s=1, index=VERIFY_INDEX,
                            card=card)
    design, splits = public_split(B, MODES_DRAFT + 1, 12, 12, 64, cfg.max_seq_len)
    verify = dict(shape=[B, MODES_DRAFT + 1, 12, 12, 64], design=design, splits=splits,
                  kernel=attention_kernel(design, MODES_DRAFT + 1, splits),
                  max_abs_err=verify_errs, ms=verify_time, token_step_ms=token_time)
    log(f"[engine] modes: verify chunk decode attention {design}/{splits} "
        f"({verify['kernel']}), {verify_time['ms'] * 1e3:.2f} us beside the token step's "
        f"{token_time['design']}/{token_time['splits']} {token_time['ms'] * 1e3:.2f} us at "
        f"index {VERIFY_INDEX}; max abs err {verify_errs}")

    variants = modes_variants(cfg)
    engines = {name: make_continuous_engine(cfg, **{**ENGINE_COMMON, **kw})
               for name, kw in variants.items()}

    def served(name, queue):
        """One serve of ``name``'s engine (key 0; the draft is the target)."""
        speculative = "draft_config" in variants[name]
        return engines[name](params, queue, rng=MODES_SEED,
                             draft_params=params if speculative else None)

    for name in engines:
        served(name, prompts[:B])                           # warm-up
    torch.cuda.synchronize()
    # Sync debug mode's first report in a process comes twice: prime it
    # with one read (its warnings logged), so each horizon below counts its
    # own synchronizing operations.
    probe = torch.ones(B, device="cuda")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            probe.cpu()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    log(f"[engine] modes: sync debug mode primed by one read: "
        f"{[str(w.message)[:80] for w in caught]}")
    runs = {}
    for name, serve in engines.items():
        eng = serve.engine
        f0, d0 = eng.model_forwards, eng.draft_forwards
        refills, rounds, syncs = [], [], []
        tally = {}
        launch = da._launch_cuda

        def recording(q, k_cache, *a, design="cuda_core", splits=1, **k):
            rows = q.shape[1] * (q.shape[2] // k_cache.shape[1])
            key = f"S={q.shape[1]} {design}/{splits} ({attention_kernel(design, rows, splits)})"
            tally[key] = tally.get(key, 0) + 1
            return launch(q, k_cache, *a, design=design, splits=splits, **k)

        refill_step, spec_round, multi = eng._refill_step, eng._spec_round, eng._multi_dispatch

        def synced(*a, **k):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return multi(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    syncs.append(sum("synchroniz" in str(w.message).lower() for w in caught))
                    if syncs[-1] != 1:
                        log(f"[engine] modes {name}: a horizon's sync warnings "
                            f"{[str(w.message)[:80] for w in caught]}")

        eng._refill_step = lambda *a: (refills.append(1), refill_step(*a))[1]
        eng._spec_round = lambda *a: (rounds.append(1), spec_round(*a))[1]
        eng._multi_dispatch = synced
        da._launch_cuda = recording
        torch.cuda.synchronize()
        reset_launches()
        try:
            outs = served(name, prompts)
            torch.cuda.synchronize()
        finally:
            da._launch_cuda = launch
            del eng._refill_step, eng._spec_round, eng._multi_dispatch
        launches = read_launches()
        calls, drafts = eng.model_forwards - f0, eng.draft_forwards - d0
        want = cfg.num_layers * (calls + drafts)
        runs[name] = dict(outs=outs, stats=serve.last_stats, latency=serve.last_latency,
                          model_forwards=calls, draft_forwards=drafts, refill_calls=len(refills),
                          rounds=len(rounds), horizon_syncs=syncs,
                          decode_attention=launches["decode_attention"],
                          decode_attention_paged=launches["decode_attention_paged"],
                          designs=tally)
        log(f"[engine] modes {name}: {calls} target + {drafts} draft model calls "
            f"({len(refills)} refill chunks, {len(rounds)} speculative rounds), decode "
            f"attention {launches['decode_attention']} launches (want {want}; "
            f"{launches['decode_attention_paged']} paged) by shape and design {tally}; "
            f"stats {serve.last_stats}")
        if launches["decode_attention"] != want:
            raise AssertionError(f"modes {name}: {launches['decode_attention']} decode attention "
                                 f"launches, want one a layer per model call ({want})")
        if "draft_config" in variants[name] and not variants[name].get("mixed"):
            # Split speculative engine: a refill chunk runs both models, a
            # round num_draft + 1 draft calls and one verify call.
            want_calls = (len(refills) + len(rounds),
                          len(refills) + (MODES_DRAFT + 1) * len(rounds))
            if (calls, drafts) != want_calls:
                raise AssertionError(f"modes {name}: (target, draft) calls {(calls, drafts)}, "
                                     f"want {want_calls}")
        if variants[name].get("horizon", 1) > 1:
            # Sync debug mode warns once a synchronizing operation; the
            # horizon's one read of its links must be the only one.
            log(f"[engine] modes {name}: synchronizing operations per horizon dispatch {syncs}")
            if not syncs or any(n != 1 for n in syncs):
                raise AssertionError(f"modes {name}: syncs per horizon {syncs}, want one each")
        for out, p in zip(outs, prompts):
            if out.shape != (len(p) + ENGINE_NEW,) or not np.array_equal(out[: len(p)], p):
                raise AssertionError(f"modes {name}: output {out.shape} is not the prompt "
                                     f"+ {ENGINE_NEW} tokens")
            if out.min() < 0 or out.max() >= cfg.vocab_size:
                raise AssertionError(f"modes {name}: token ids out of range")

    dense = Transformer(dataclasses.replace(cfg, param_dtype=torch.bfloat16), device="cuda",
                        seed=1).eval()
    dense.load_state_dict(params)
    greedy = [n for n in variants if "temperature" not in variants[n]]
    gaps, agree = {}, {}
    for name in greedy:
        outs, split = runs[name]["outs"], runs["split"]["outs"]
        gaps[name] = engine_gap(dense, outs)
        agree[name] = float(np.mean([np.mean(a[start:] == b[start:])
                                     for a, b in zip(outs, split)]))
        log(f"[engine] modes {name}: teacher-forced max gap {gaps[name]:.4f} (limit {TF_GAP}), "
            f"tokens equal to the split engine's {agree[name]:.1%}")
    bad = {k: v for k, v in gaps.items() if not v <= TF_GAP}
    if bad:
        raise AssertionError(f"modes teacher-forced gaps {bad} > {TF_GAP}")
    horizon_gaps = first_difference_gaps(dense, runs["mixed+horizon 4"]["outs"],
                                         runs["mixed"]["outs"], start)
    log(f"[engine] modes horizon 4 against horizon 1: {len(horizon_gaps)} of "
        f"{ENGINE_REQUESTS} requests differ, first-difference logit gaps {horizon_gaps} "
        f"(limit {TF_GAP})")
    if any(g > TF_GAP for g in horizon_gaps.values()):
        raise AssertionError(f"horizon tokens leave the mixed engine's past a near tie: "
                             f"{horizon_gaps}")
    for name in ("self-draft spec", "self-draft spec+paged+prefix"):
        st = runs[name]["stats"]
        log(f"[engine] modes {name}: spec_accept_rate {st['spec_accept_rate']:.4f} "
            f"({st['spec_accepted']} of {st['spec_proposed']} proposals), the verify chunk on "
            f"{verify['design']}/{verify['splits']} ({verify['kernel']})")

    # Sampled variants: the support, then the queue reversed under its ids.
    support, reverse = {}, {}
    for name in ("sampled", "sampled self-draft spec"):
        total, outside, worst = support_check(dense, runs[name]["outs"], start)
        support[name] = dict(tokens=total, outside_strict=outside, worst_shortfall=worst)
        log(f"[engine] modes {name}: {total} sampled tokens, {outside} outside the dense "
            f"forward's strict filtered support, largest shortfall below its smallest kept "
            f"logit {worst:.4f} (limit {TF_GAP})")
        if worst > TF_GAP:
            raise AssertionError(f"modes {name}: a sampled token {worst} below the support")
        eng = engines[name].engine
        speculative = "draft_config" in variants[name]
        for i in reversed(range(ENGINE_REQUESTS)):
            eng.add_request(prompts[i], rid=i)
        got = {}
        while eng.has_work():
            eng.step(params, params if speculative else None)
            got.update(eng.pop_finished())
        back = [got[i] for i in range(ENGINE_REQUESTS)]
        key = eng.rng

        def perturbed(i, j, logits):
            # The split engine's draw at generated position j of request i.
            noise = prng.gumbel(prng.fold_in(prng.fold_in(key, i), j), logits.shape)
            return filtered_logits(logits, **MODES_SAMPLING) + noise

        ties = first_difference_gaps(dense, back, runs[name]["outs"], start,
                                     None if speculative else perturbed)
        same = sum(np.array_equal(a, b) for a, b in zip(back, runs[name]["outs"]))
        reverse[name] = dict(equal=same, first_difference_gaps=ties)
        log(f"[engine] modes {name} in reverse order: {same} of {ENGINE_REQUESTS} requests "
            f"equal; first differences {ties}")
        if ties and (speculative or any(g > TF_GAP for g in ties.values())):
            raise AssertionError(f"modes {name}: the reversed queue's tokens differ past a "
                                 f"near tie of the perturbed scores: {ties}")
    del dense

    latencies = {}

    def timed(name):
        def run_once():
            served(name, prompts)
            latencies.setdefault(name, []).append(
                (engines[name].last_latency, engines[name].last_stats))
        return run_once

    secs = interleaved_seconds({name: timed(name) for name in engines}, ENGINE_TIME_ROUNDS)
    timing = {}
    for name, times in secs.items():
        sec = statistics.median(times)
        lats = [lat for lat, _ in latencies[name]]
        rates = [st["spec_accept_rate"] for _, st in latencies[name]
                 if st and st.get("spec_accept_rate") is not None]
        timing[name] = dict(
            tok_s=ENGINE_REQUESTS * ENGINE_NEW / sec, seconds=times, median_s=sec,
            ttft_p50=statistics.median(x["ttft_p50"] for x in lats),
            itl_p99=statistics.median(x["itl_p99"] for x in lats),
            decode_stall_share=statistics.median(x["decode_stall_share"] for x in lats),
            spec_accept_rate=statistics.median(rates) if rates else None)
        t = timing[name]
        log(f"[time] engine modes {name} (interleaved): {t['tok_s']:.1f} generated tok/s, "
            f"{sec:.3f} s per serve (median of {ENGINE_TIME_ROUNDS}: "
            f"{[round(x, 4) for x in times]}); TTFT p50 "
            f"{t['ttft_p50'] * 1e3:.1f} ms, ITL p99 {t['itl_p99'] * 1e3:.1f} ms, decode stall "
            f"share {t['decode_stall_share']:.3f}, spec_accept_rate {t['spec_accept_rate']} "
            f"on {card}")

    profiles = {}
    for name in ("split", "mixed", "mixed+horizon 4", "self-draft spec", "sampled"):
        eng = engines[name].engine
        f0 = eng.model_forwards + eng.draft_forwards
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served(name, prompts[:B])
        torch.cuda.synchronize()
        wave_ms = (time.perf_counter() - t0) * 1e3
        calls = eng.model_forwards + eng.draft_forwards - f0
        profiles[name] = profile_summary(
            f"engine modes {name}, one wave of 8 requests, per model call ({calls} a wave)",
            lambda name=name: served(name, prompts[:B]), calls, wave_ms / calls)
    summary = {name: {k: v for k, v in r.items() if k != "outs"} for name, r in runs.items()}
    del engines
    return dict(verify=verify, runs=summary, teacher_forced_max_gap=gaps,
                equal_to_split=agree, horizon_first_differences=horizon_gaps,
                sampled_support=support, sampled_reverse=reverse, timing=timing,
                profiles=profiles)


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


def time_int4_decode(q4, prompt, card):
    """The int4-fused and int4-w4a8 generates (b=8, prompt 128,
    +``INT4_TIME_NEW``), host clock around a synchronised call, medians of 3
    interleaved, beside the
    same calls with every matmul that the rule gives the small-M design
    (the decode steps') launched on the CUDA-core design instead, and the
    int4-fused generate with every ``int4_ff`` on its CUDA-core design;
    then each of the five profiled: device-busy ms per token step and the
    int4 matmuls' and ``int4_ff``'s ms per step (their kernels' profiled
    time over ``INT4_TIME_NEW`` steps)."""
    calls = {}
    for mode, name in (("fused", "int4-fused"), ("fused_w4a8", "int4-w4a8")):
        fn = make_generate_fn(CONFIG_125M, max_new_tokens=INT4_TIME_NEW,
                              inference_dtype=torch.bfloat16, dequantize=mode)
        run = functools.partial(fn, q4, prompt)
        calls[name] = run
        calls[f"{name}, decode on the CUDA cores"] = on_design(run, "cuda_core", only="small_m")
    calls["int4-fused, int4_ff on the CUDA cores"] = on_design(
        calls["int4-fused"], "cuda_core", module=ff4, rule="_design")
    times = interleaved_seconds(calls)
    rows = {}
    for name, run in calls.items():
        sec = statistics.median(times[name])
        ms = sec / INT4_TIME_NEW * 1e3
        prof = profile_summary(f"125M {name} generate token step", run, INT4_TIME_NEW, ms)
        int4_ms = sum(v for kernel, v in prof["port_kernels_ms_per_step"].items()
                      if kernel.startswith("int4_matmul"))
        ff_ms = sum(v for kernel, v in prof["port_kernels_ms_per_step"].items()
                    if kernel.startswith("int4_ff"))
        rows[name] = dict(tok_s=B * INT4_TIME_NEW / sec, ms_per_token_step=ms,
                          seconds=times[name], int4_matmul_ms_per_step=int4_ms,
                          int4_ff_ms_per_step=ff_ms, profile=prof, new=INT4_TIME_NEW)
        log(f"[time] 125M {name} generate b={B} prompt {PROMPT} +{INT4_TIME_NEW} "
            f"(interleaved): {B * INT4_TIME_NEW / sec:.1f} tok/s, {ms:.3f} ms/token-step (median of 3: "
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


# The mesh phases (slice A). "[mesh] 1x1": the train step and the three
# generates over a one-rank mesh on this card, against the unsharded port.
# "[mesh] 2x2 on one card": four ranks cannot be four processes on one card
# (NCCL refuses two ranks on one GPU, and gloo's all-gather of CUDA tensors,
# which DTensor's redistributions issue, hangs: a probe on an H100 with
# torch 2.11), so they are four threads of this process over torch's
# in-process threaded group (``parallel.run_on_threads``), running
# ``scripts/mesh_cards.py``'s train call and generates through the mesh
# wrappers. "[mesh] shards": every shard of a (2, 2) and a (2, 4) data x
# model layout through the kernels, one after another, stitched and held to
# the whole, each shard's launch held to the design rule at its shape.
MESH_RULES_TRAIN = "RULES_DP_TP_SP"
MESH_RULES_GENERATE = "RULES_DP_TP"
MESH_LOSS_RTOL = 1e-5
MESH_LAYOUTS = ((2, 2), (2, 4))
# The (2, 2) thread-rank generates: +4 tokens (about 2 s a model call on a
# slow host; at +16 the phase took 70 s; cut from +8 to make room for
# [train] remat and [beam]).
MESH_THREAD_STEPS, MESH_THREAD_NEW = 2, 4
# The one-rank mesh generates: +8 tokens (the unsharded ones +128): a mesh
# token step is host-bound at 3-5x the unsharded one, and at +128 the three
# generates took 100 s of the run on a slow host (46 s at +32; cut from +16
# with the thread-rank generates).
MESH_1X1_NEW = 8


def _kernel_launches() -> dict:
    """Every counter of the kernels on the mesh paths."""
    return {**{f"flash_{k}": v for k, v in flash.flash_attention.launches.items()},
            **{f"fused_norm_{k}": v for k, v in norm_ops.fused_residual_norm.launches.items()},
            **read_launches()}


def _reset_kernel_launches() -> None:
    flash.flash_attention.launches = dict.fromkeys(flash.flash_attention.launches, 0)
    reset_norm_launches()
    reset_launches()


def run_mesh_1x1(gen, card):
    """The 125M train step (flash, fused norm, fused loss, AdamW, b=8,
    s=1024, bf16, one 8-step call) and the float, "fused" and "fused_w4a8"
    generates (b=8, 128 + 128) over a one-rank cuda mesh, each against the
    same unsharded call from the same weights: the same kernel launches, the
    same greedy tokens, the train losses within ``MESH_LOSS_RTOL``; then
    both timed interleaved (the difference: DTensor's dispatch on one card)."""
    from learning_jax_sharding_tpu_torch.parallel import logical, single_device_mesh

    mesh = single_device_mesh(device_type="cuda")
    rules_t = getattr(logical, MESH_RULES_TRAIN)
    rules_g = getattr(logical, MESH_RULES_GENERATE)
    out = {"train": {}, "generate": {}}
    batch = train_batch(gen, CONFIG_125M.vocab_size)
    stacked = {k: v.expand(K_STEPS, *v.shape) for k, v in batch.items()}
    states, steps = {}, {}
    for name, kw in (("mesh", dict(mesh=mesh, rules=rules_t)), ("one", {})):
        fn = flash.make_flash_attn_fn(mesh, rules_t) if name == "mesh" else \
            flash.make_flash_attn_fn()
        cfg = dataclasses.replace(CONFIG_125M, attn_fn=fn, fused_norm=True)
        states[name] = sharded_train_state(Transformer(cfg, device="cuda", seed=0),
                                           adamw(3e-4), **kw)
        steps[name] = make_train_step(steps_per_call=K_STEPS, **TRAIN_LOSS, **kw)
    losses, launches = {}, {}
    for name, state in states.items():
        torch.cuda.synchronize()
        _reset_kernel_launches()
        _, call = steps[name](state, stacked)
        torch.cuda.synchronize()
        losses[name], launches[name] = call.tolist(), _kernel_launches()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["mesh"], losses["one"]))
    log(f"[mesh] 1x1 125M train ({MESH_RULES_TRAIN}, fused norm, one {K_STEPS}-step call): "
        f"losses {[round(x, 5) for x in losses['mesh']]} vs unsharded "
        f"{[round(x, 5) for x in losses['one']]}, max rel diff {rel:.2e} "
        f"(limit {MESH_LOSS_RTOL:g}); launches {launches['mesh']}")
    if launches["mesh"] != launches["one"]:
        raise AssertionError(f"[mesh] 1x1 train launched {launches['mesh']}, the unsharded "
                             f"step {launches['one']}")
    if not rel <= MESH_LOSS_RTOL:
        raise AssertionError(f"[mesh] 1x1 train losses differ by {rel} relative")
    times = interleaved_seconds({name: functools.partial(steps[name], state, stacked)
                                 for name, state in states.items()}, MESH_TIME_ROUNDS)
    ms = {name: statistics.median(t) / K_STEPS * 1e3 for name, t in times.items()}
    log(f"[time] [mesh] 1x1 125M train step (interleaved, median of {MESH_TIME_ROUNDS} "
        f"{K_STEPS}-step calls): "
        f"mesh {ms['mesh']:.3f} ms/step, unsharded {ms['one']:.3f}; DTensor dispatch "
        f"{ms['mesh'] - ms['one']:.3f} ms/step on {card}")
    out["train"] = dict(losses=losses, max_rel_diff=rel, launches=launches["mesh"],
                        ms_per_step=ms, dtensor_ms_per_step=ms["mesh"] - ms["one"],
                        call_seconds=times)
    del states
    torch.cuda.empty_cache()

    params = Transformer(CONFIG_125M, device="cuda", seed=0).state_dict()
    q4 = quantize_tree(params, bits=4)
    prompt = torch.randint(0, CONFIG_125M.vocab_size, (B, PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    for mode in (False, "fused", "fused_w4a8"):
        label = mode or "float"
        tree = q4 if mode else params
        fns = {"mesh": make_generate_fn(CONFIG_125M, mesh, rules_g, max_new_tokens=MESH_1X1_NEW,
                                        inference_dtype=torch.bfloat16, dequantize=mode),
               "one": make_generate_fn(CONFIG_125M, max_new_tokens=MESH_1X1_NEW,
                                       inference_dtype=torch.bfloat16, dequantize=mode)}
        toks, launches = {}, {}
        for name, fn in fns.items():
            torch.cuda.synchronize()
            _reset_kernel_launches()
            toks[name] = fn(tree, prompt)
            torch.cuda.synchronize()
            launches[name] = _kernel_launches()
        same = bool(torch.equal(toks["mesh"], toks["one"]))
        log(f"[mesh] 1x1 125M generate {label} ({MESH_RULES_GENERATE}) b={B} prompt {PROMPT} "
            f"+{MESH_1X1_NEW}: tokens equal to the unsharded generate's: {same}; launches "
            f"{ {k: v for k, v in launches['mesh'].items() if v} }")
        if launches["mesh"] != launches["one"]:
            raise AssertionError(f"[mesh] 1x1 generate {label} launched {launches['mesh']}, the "
                                 f"unsharded generate {launches['one']}")
        if not same:
            raise AssertionError(f"[mesh] 1x1 generate {label}: tokens differ from the "
                                 f"unsharded generate's")
        # One round (the checked calls above warmed both up): the mesh
        # generates are host-bound at 4-8x the unsharded time. A token step
        # here is a whole call over its MESH_1X1_NEW new tokens, the prefill
        # included, so it depends on that depth.
        times = interleaved_seconds({name: functools.partial(fn, tree, prompt)
                                     for name, fn in fns.items()}, rounds=1)
        ms = {name: statistics.median(t) / MESH_1X1_NEW * 1e3 for name, t in times.items()}
        log(f"[time] [mesh] 1x1 125M generate {label} (interleaved, one call each, over its "
            f"+{MESH_1X1_NEW} with the prefill): mesh {ms['mesh']:.3f} ms/token-step, unsharded "
            f"{ms['one']:.3f}; DTensor dispatch {ms['mesh'] - ms['one']:.3f} ms/token-step on "
            f"{card}")
        out["generate"][label] = dict(launches=launches["mesh"], ms_per_token_step=ms,
                                      dtensor_ms_per_token_step=ms["mesh"] - ms["one"],
                                      seconds=times)
    # Of the mesh generate's time: laying the weights out over the mesh,
    # once a call (``shard_params`` on the 125M bf16 weights).
    model = Transformer(derive_decode_config(CONFIG_125M, torch.bfloat16), device="cuda")
    weights = {k: v.to(torch.bfloat16) for k, v in params.items()}
    lay = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shard_params(model, mesh, rules_g, weights)
        torch.cuda.synchronize()
        lay.append(time.perf_counter() - t0)
    out["shard_params_ms"] = statistics.median(lay) * 1e3
    log(f"[time] [mesh] 1x1 shard_params of the 125M bf16 weights: "
        f"{out['shard_params_ms']:.3f} ms a generate call (median of 3), "
        f"{out['shard_params_ms'] / MESH_1X1_NEW:.3f} ms a token step at {MESH_1X1_NEW} new "
        f"tokens, on {card}")
    return out


def run_mesh_threads(card):
    """The (2, 2) data x model mesh on this card, its four ranks threads of
    this process: ``scripts/mesh_cards.py``'s 125M fused-norm train call
    (``MESH_THREAD_STEPS`` steps, ``RULES_DP_TP_SP``) and its float and
    int4-fused generates (b=8, 128 + ``MESH_THREAD_NEW``, ``RULES_DP_TP``)
    through the mesh wrappers, against the same calls unsharded: the losses
    within its ``LOSS_RTOL``, each generate's tokens teacher-forced within
    its ``TF_GAP``, and the four ranks' launches of every kernel, counted
    from zero around the run, equal to ``mesh_cards.tp_launches``. Its wall
    time only: the ranks take turns on one card and one interpreter."""
    from learning_jax_sharding_tpu_torch.parallel import run_on_threads
    from learning_jax_sharding_tpu_torch.scripts import mesh_cards

    kw = dict(steps=MESH_THREAD_STEPS, new=MESH_THREAD_NEW, rounds=0)
    one = mesh_cards.run(**kw)
    torch.cuda.synchronize()
    _reset_kernel_launches()
    t0 = time.perf_counter()
    mesh = run_on_threads(functools.partial(mesh_cards.run, count=False, **kw),
                          mesh_cards.SHAPE, device_type="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ranks = math.prod(mesh_cards.SHAPE)
    launches, want = mesh_cards._launches(), mesh_cards.tp_launches(one, ranks)
    result = mesh_cards.compare(mesh, one, MESH_THREAD_NEW)
    result.update(seconds=seconds, launches=launches, ranks=ranks)
    log(f"[mesh] 2x2 on one card ({ranks} ranks as threads): losses "
        f"{[round(x, 5) for x in result['losses']['mesh']]} vs unsharded "
        f"{[round(x, 5) for x in result['losses']['one']]}, max rel diff "
        f"{result['loss_max_rel_diff']:.2e} (limit {mesh_cards.LOSS_RTOL:g})")
    for mode in ("float", "fused"):
        log(f"[mesh] 2x2 on one card generate {mode}: tokens equal to the unsharded "
            f"generate's {result[mode]['equal_share']:.4f} (first differing step "
            f"{result[mode]['first_differing_step']}), teacher-forced gap "
            f"{result[mode]['teacher_forced_max_gap']:.4f} (limit {mesh_cards.TF_GAP:g})")
    log(f"[mesh] 2x2 on one card: launches of the {ranks} ranks "
        f"{ {k: v for k, v in launches.items() if v} }; {seconds:.1f} s wall on {card}")
    bad = mesh_cards.failures(result)
    if launches != want:
        bad.append(f"launched {launches}, want {want}")
    if bad:
        raise AssertionError(f"[mesh] 2x2 on one card: {'; '.join(bad)}")
    return result


# The engine over a mesh (``[engine] mesh``): the first eight requests of
# engine_prompts() (one wave of the 8 slots), ENGINE_COMMON otherwise; the
# (2, 2) variants as four thread ranks of this process on the one card,
# +2 tokens a request in decode blocks of 2, the speculative variant +8 in
# blocks of two rounds (a request's two verify rounds in one block, so the
# state carried from round to round runs over the mesh): a thread-rank
# model call takes far longer than a one-rank one (DTensor's dispatch of
# four ranks in one interpreter); at ENGINE_COMMON's +32 the phase outgrew
# its 150 s, and at +8 everywhere (8 rounds a speculative block) it took
# 200 s of the run on a slow host.
MESH_ENGINE_REQUESTS = 8
MESH_ENGINE_SHAPE = (2, 2)
MESH_ENGINE_NEW = 2
MESH_SPEC_NEW = 8
MESH_SPEC_ROUNDS = 2   # the (2, 2) speculative variant's rounds a decode block


def check_mesh_shards(gen):
    """Decode attention against its plain version at the shard shapes the
    ``[engine] mesh`` phase launches on its (2, 2) ranks (the 125M's 12
    heads over ``model``, 6 a shard; H=64, 1024-slot caches): under
    ``RULES_DP_TP`` (4 rows a shard) the split engine's refill chunk
    (S=64), its folded token step (S=1, one row's write disabled) and the
    speculative verify chunk (S = ``MODES_DRAFT`` + 1); under
    ``RULES_TP_SERVING`` (8 rows) the paged token step (a folded write at
    544-575, two rows sharing an 8-page prefix) and refill chunk (S=64 at
    512) over 64-slot pages. Ragged row indices; fp32 and bf16, each through
    the public call, every ``decode_variants`` launch and the public design
    at every ``SPLIT_SWEEP`` split, within ``TOL`` → {shape: {dtype: the
    largest max abs error}}."""
    rows, heads = B // MESH_ENGINE_SHAPE[0], CONFIG_125M.num_heads // MESH_ENGINE_SHAPE[1]
    h, length = CONFIG_125M.head_dim, CONFIG_125M.max_seq_len
    start = ENGINE_SYSTEM + ENGINE_OWN
    mha = dict(n=heads, n_kv=heads, h=h)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        def sweep(b, s):
            design = public_split(b, s, heads, heads, h, length, dtype)[0]
            return list(dict.fromkeys(decode_variants(dtype)
                                      + [(design, sp) for sp in SPLIT_SWEEP]))

        def ragged(lo, hi):
            return torch.randint(lo, hi, (rows,), generator=gen, device="cuda",
                                 dtype=torch.int32)
        enable = torch.ones(rows, dtype=torch.int32, device="cuda")
        enable[rows // 2] = 0
        spec_s = MODES_DRAFT + 1
        paged = dict(page=ENGINE_PAGE, t_cap=length // ENGINE_PAGE, shared=8, **mha)
        got = {
            f"refill chunk ({rows}, {PAGED_CHUNK}, {heads}, {h})": kernel_case(
                "(2, 2) shard refill chunk", gen, dtype, b=rows, s=PAGED_CHUNK,
                length=length, index=ragged(0, ENGINE_SYSTEM + 1),
                variants=sweep(rows, PAGED_CHUNK), **mha),
            f"folded token step ({rows}, 1, {heads}, {h})": kernel_case(
                "(2, 2) shard folded token step", gen, dtype, b=rows, s=1, length=length,
                index=ragged(start, start + 32), fold=True, write_enable=enable,
                variants=sweep(rows, 1), **mha),
            f"verify chunk ({rows}, {spec_s}, {heads}, {h})": kernel_case(
                "(2, 2) shard verify chunk", gen, dtype, b=rows, s=spec_s, length=length,
                index=ragged(start, length - spec_s), variants=sweep(rows, spec_s), **mha),
            f"paged token step ({B}, 1, {heads}, {h})": paged_case(
                "(2, 2) shard token step p64", gen, dtype, b=B, s=1, lo=start, hi=start + 32,
                fold=True, variants=sweep(B, 1), **paged),
            f"paged refill chunk ({B}, {PAGED_CHUNK}, {heads}, {h})": paged_case(
                "(2, 2) shard refill chunk p64", gen, dtype, b=B, s=PAGED_CHUNK,
                lo=ENGINE_SYSTEM, hi=ENGINE_SYSTEM + 1, variants=sweep(B, PAGED_CHUNK),
                **paged),
        }
        for shape, err in got.items():
            errs.setdefault(shape, {})[str(dtype)[6:]] = err
    return errs


def run_engine_mesh(gen, card):
    """``[engine] mesh``: the 125M continuous engine (bf16, blocked, seeded
    random weights) over a mesh on ``MESH_ENGINE_REQUESTS`` requests of the
    engine queue. (a) A one-rank cuda mesh under ``RULES_DP_TP`` against
    ``mesh=None``: the same launches of every kernel and the same tokens;
    both serves timed interleaved (the host ms a model call the mesh adds)
    and the mesh serve profiled a model call. (b) Four thread ranks on a
    (2, 2) mesh: split under ``RULES_DP_TP``, paged + prefix under
    ``RULES_TP_SERVING`` (cold, then warm), self-draft speculation
    (``MODES_DRAFT`` proposals, ``MESH_SPEC_ROUNDS`` rounds a block) under
    ``RULES_DP_TP``, +``MESH_SPEC_NEW`` tokens a request, the others
    +``MESH_ENGINE_NEW``. Gates:
    every rank served the same tokens and stats; each rank launched decode
    attention once a layer per model call (target and draft), and the
    kernel's counters (reset before, read after) hold the four ranks'
    launches; warm prefix hits 8/8; two verify rounds a speculative
    request or more; every variant's
    requests teacher-forced within ``TF_GAP`` of the dense bf16 forward
    (bf16 sums over a (2, 2) mesh round otherwise than on one device, so
    tokens are not held bit-equal there). Wall time only: the ranks take
    turns on one card and one interpreter, so no tensor-parallel speed-up
    is measured. Then decode attention at the shard shapes held to its
    plain version (``check_mesh_shards``) and timed."""
    import torch.distributed as dist

    from learning_jax_sharding_tpu_torch.models import attention as attn_mod
    from learning_jax_sharding_tpu_torch.parallel import (
        logical,
        run_on_threads,
        single_device_mesh,
    )

    cfg = dataclasses.replace(CONFIG_125M, decode_attention="blocked")
    params = Transformer(CONFIG_125M, device="cuda", seed=0).state_dict()
    prompts = engine_prompts()[:MESH_ENGINE_REQUESTS]
    out = {"one_rank": {}, "threads": {}}

    # (a) A one-rank mesh against no mesh.
    mesh = single_device_mesh(device_type="cuda")
    serves = {"mesh": make_continuous_engine(cfg, mesh, logical.RULES_DP_TP, **ENGINE_COMMON),
              "one": make_continuous_engine(cfg, **ENGINE_COMMON)}
    toks, launches, calls = {}, {}, {}
    for name, serve in serves.items():
        torch.cuda.synchronize()
        reset_launches()
        forwards = serve.engine.model_forwards
        toks[name] = serve(params, prompts)
        torch.cuda.synchronize()
        launches[name] = read_launches()
        calls[name] = serve.engine.model_forwards - forwards
    same = [np.array_equal(a, b) for a, b in zip(toks["mesh"], toks["one"])]
    log(f"[engine] mesh 1x1 split (RULES_DP_TP): {calls['mesh']} model calls (no mesh "
        f"{calls['one']}), tokens equal to the engine without a mesh in {sum(same)} of "
        f"{len(same)} requests; launches {({k: v for k, v in launches['mesh'].items() if v})}")
    if (launches["mesh"] != launches["one"] or calls["mesh"] != calls["one"] or not all(same)
            or launches["mesh"]["decode_attention"] != cfg.num_layers * calls["mesh"]):
        raise AssertionError(f"[engine] mesh 1x1: launches {launches}, model calls {calls}, "
                             f"equal requests {same}")
    secs = interleaved_seconds({name: functools.partial(serve, params, prompts)
                                for name, serve in serves.items()}, MESH_TIME_ROUNDS)
    ms = {name: statistics.median(t) * 1e3 / calls[name] for name, t in secs.items()}
    profile = profile_summary(f"125M engine serve over a one-rank mesh, per model call "
                              f"({calls['mesh']} a serve)",
                              functools.partial(serves["mesh"], params, prompts), calls["mesh"],
                              ms["mesh"])
    out["one_rank"] = dict(model_calls=calls["mesh"], launches=launches["mesh"],
                           ms_per_model_call=ms, host_ms_added=ms["mesh"] - ms["one"],
                           seconds=secs, profile=profile, tokens_equal=sum(same))
    log(f"[time] [engine] mesh 1x1 split serve (interleaved, medians of {MESH_TIME_ROUNDS}): mesh "
        f"{ms['mesh']:.3f} ms a model call, no mesh {ms['one']:.3f}; the mesh adds "
        f"{ms['mesh'] - ms['one']:.3f} ms of host time a model call on {card}")
    one_toks = toks["one"]
    del serves
    torch.cuda.empty_cache()

    # (b) Four thread ranks on a (2, 2) mesh.
    common = dict(ENGINE_COMMON, max_new_tokens=MESH_ENGINE_NEW,
                  decode_block_steps=MESH_ENGINE_NEW)
    paged = dict(paged_pages=ENGINE_PAGES, page_size=ENGINE_PAGE, prefix_cache=True)
    spec = dict(draft_config=cfg, num_draft=MODES_DRAFT, max_new_tokens=MESH_SPEC_NEW,
                decode_block_steps=MESH_SPEC_ROUNDS)
    variants = {"split": ("RULES_DP_TP", {}, 1),
                "paged+prefix": ("RULES_TP_SERVING", paged, 2),
                "self-draft spec": ("RULES_DP_TP", spec, 1)}
    per_rank = [0] * math.prod(MESH_ENGINE_SHAPE)
    inner = attn_mod.decode_attention

    def counted(*args, **kwargs):
        # Each rank's own calls of the kernel wrapper (a rank is a thread).
        per_rank[dist.get_rank()] += 1
        return inner(*args, **kwargs)

    def body(mesh):
        results = {}
        for name, (rules, kw, serves_n) in variants.items():
            serve = make_continuous_engine(cfg, mesh, getattr(logical, rules), **{**common, **kw})
            eng = serve.engine
            for call in range(serves_n):
                label = name if serves_n == 1 else f"{name} {('cold', 'warm')[call]}"
                fwd, dfwd = eng.model_forwards, eng.draft_forwards
                dist.barrier()
                if dist.get_rank() == 0:
                    reset_launches()
                    per_rank[:] = [0] * len(per_rank)
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = serve(params, prompts, draft_params=params if "draft_config" in kw
                             else None)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                dist.barrier()
                results[label] = dict(
                    rules=rules, tokens=[o.tolist() for o in outs], stats=serve.last_stats,
                    model_calls=eng.model_forwards - fwd, draft_calls=eng.draft_forwards - dfwd,
                    rank_launches=per_rank[dist.get_rank()], seconds=seconds,
                    ttft_p50=serve.last_latency["ttft_p50"],
                    launches=read_launches() if dist.get_rank() == 0 else None)
                dist.barrier()
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, {k: {f: v[f] for f in ("tokens", "stats", "model_calls",
                                                             "draft_calls", "rank_launches")}
                                        for k, v in results.items()})
        return results, ranks

    attn_mod.decode_attention = counted
    t0 = time.perf_counter()
    try:
        results, ranks = run_on_threads(body, MESH_ENGINE_SHAPE, device_type="cuda")
    finally:
        attn_mod.decode_attention = inner
    wall = time.perf_counter() - t0
    dense = Transformer(dataclasses.replace(cfg, param_dtype=torch.bfloat16), device="cuda",
                        seed=1).eval()
    dense.load_state_dict(params)
    bad = []
    for label, r in results.items():
        new = MESH_SPEC_NEW if label == "self-draft spec" else MESH_ENGINE_NEW
        outs = [np.asarray(t, np.int32) for t in r["tokens"]]
        gap = engine_gap(dense, outs)
        ref = [o[:len(p) + new] for o, p in zip(one_toks, prompts)]
        calls_n = r["model_calls"] + r["draft_calls"]
        want = cfg.num_layers * calls_n
        same = sum(np.array_equal(a, b) for a, b in zip(outs, ref))
        row = dict(tok_s=len(prompts) * new / r["seconds"], seconds=r["seconds"],
                   ttft_p50=r["ttft_p50"], model_calls=r["model_calls"],
                   draft_calls=r["draft_calls"], ms_per_model_call=r["seconds"] * 1e3 / calls_n,
                   teacher_forced_max_gap=gap, stats=r["stats"], launches=r["launches"],
                   rank_launches=[x[label]["rank_launches"] for x in ranks],
                   tokens_equal_to_one_device=same)
        out["threads"][label] = row
        log(f"[engine] mesh 2x2 {label} ({r['rules']}, {len(ranks)} thread ranks): "
            f"{row['tok_s']:.1f} generated tok/s, TTFT p50 "
            f"{row['ttft_p50'] * 1e3:.1f} ms, {r['model_calls']} model calls + "
            f"{r['draft_calls']} draft calls, {row['ms_per_model_call']:.3f} ms a model call "
            f"(wall, the ranks taking turns on one card); decode attention a rank "
            f"{row['rank_launches']} (want {want}), all ranks {r['launches']['decode_attention']} "
            f"({r['launches']['decode_attention_paged']} paged, "
            f"{r['launches']['decode_attention_tensor_core']} tensor-core, "
            f"{r['launches']['decode_attention_split']} split); teacher-forced gap {gap:.4f} "
            f"(limit {TF_GAP}); tokens equal to the one-device engine's in {same} of "
            f"{len(outs)} requests; stats {r['stats']} on {card}")
        if any(x[label] != ranks[0][label] for x in ranks):
            bad.append(f"{label}: the ranks served different tokens or stats")
        if any(n != want for n in row["rank_launches"]):
            bad.append(f"{label}: decode attention a rank {row['rank_launches']}, want {want}")
        if r["launches"]["decode_attention"] != sum(row["rank_launches"]):
            bad.append(f"{label}: the kernel counted {r['launches']['decode_attention']} "
                       f"launches, the ranks {sum(row['rank_launches'])}")
        if not gap <= TF_GAP:
            bad.append(f"{label}: teacher-forced gap {gap} > {TF_GAP}")
        for o, p in zip(outs, prompts):
            if o.shape != (len(p) + new,) or not np.array_equal(o[: len(p)], p):
                bad.append(f"{label}: an output is not its prompt + {new} tokens")
    warm = out["threads"]["paged+prefix warm"]["stats"]
    if warm["prefix_hits"] != len(prompts):
        bad.append(f"paged+prefix warm: prefix hits {warm['prefix_hits']}, want {len(prompts)}")
    # Two verify rounds a request at least: the draft proposes MODES_DRAFT
    # tokens a row in every round.
    spec_rounds = (out["threads"]["self-draft spec"]["stats"]["spec_proposed"]
                   / (MODES_DRAFT * len(prompts)))
    out["threads"]["self-draft spec"]["verify_rounds_a_request"] = spec_rounds
    log(f"[engine] mesh 2x2 self-draft spec: {spec_rounds:g} verify rounds a request")
    if spec_rounds < 2:
        bad.append(f"self-draft spec: {spec_rounds:g} verify rounds a request, want 2 or more")
    del dense
    torch.cuda.empty_cache()
    log(f"[engine] mesh 2x2: {wall:.1f} s wall for the {len(results)} serves on {card}")
    if bad:
        raise AssertionError(f"[engine] mesh: {'; '.join(bad)}")

    # The shard shapes this phase launched, held to the plain version, then
    # timed.
    checks = check_mesh_shards(gen)
    log(f"[engine] mesh shard shapes: decode attention within {TOL[torch.float32]:g} (fp32) "
        f"and {TOL[torch.bfloat16]:g} (bf16) of its plain version in every launch; max abs err "
        + "; ".join(f"{shape} {e}" for shape, e in checks.items()))
    shard = MESH_ENGINE_SHAPE
    b_shard, n_shard = B // shard[0], CONFIG_125M.num_heads // shard[1]
    out["shard_shapes"] = {
        f"refill chunk ({b_shard}, {PAGED_CHUNK}, {n_shard}, 64)": time_shape(
            gen, "(2, 2) shard refill chunk", s=PAGED_CHUNK, index=ENGINE_SYSTEM, card=card,
            n=n_shard, b=b_shard),
        f"verify chunk ({b_shard}, {MODES_DRAFT + 1}, {n_shard}, 64)": time_shape(
            gen, "(2, 2) shard verify chunk", s=MODES_DRAFT + 1, index=VERIFY_INDEX, card=card,
            n=n_shard, b=b_shard),
        f"paged token step ({B}, 1, {n_shard}, 64)": time_paged(
            gen, card, n=n_shard, shapes=("decode",))["decode"],
    }
    for shape, row in out["shard_shapes"].items():
        row["max_abs_err"] = checks[shape]
    out["shard_checks"] = checks
    out["wall_s"] = wall
    return out


# The [engine] policies phase: its SLO targets for the telemetry serve (an
# objective a 125M serve meets), the request its sticky fault poisons.
POLICY_SLO = (("ttft", 1.0, 0.99), ("itl", 0.5, 0.99), ("e2e", 5.0, 0.99))
POLICY_POISON = 1


def run_engine_policies(ref_outs, card):
    """``[engine] policies`` (slice 17): the 125M engine with its telemetry
    and recovery policies, on the ``[engine]`` phase's weights (seed 0) and
    its first ``B`` prompts, bf16, ``ENGINE_COMMON``. (1) Telemetry attached:
    a paged + prefix serve (cold) with its own registry, tracer, flight
    recorder, SLO monitor and a trace sink, counted: tokens equal to those
    the ``[engine]`` phase served for the same prompts (``ref_outs``),
    decode attention once a layer per model call (what that phase gates:
    the telemetry adds no launch), ``reconcile()`` within ε; the ledger's
    window report, its telemetry share and the host ms a model call it
    books; the serve profiled a model call; then two streaming steps under
    ``utils/profiling.trace``, whose capture must hold the engine's
    ``engine.refill_step`` and ``engine.decode_block`` ranges. (2) The
    policies, each a gate: a request with ``deadline_s=1e-6`` ends
    ``"deadline"``; ``max_queue=2`` raises ``AdmissionError`` with
    ``engine_shed_total`` 1; a sticky ``Fault("engine.dispatch", "hang",
    rid=k, count=-1)`` ends ``"poisoned"`` with ``engine_quarantined_total``
    1 while its batchmates' tokens are bit-equal to the clean serve; a
    self-draft speculative engine with ``SLOMonitor([SLOTarget("ttft",
    1e-9, objective=0.5)])`` and ``DegradationLadder(patience=1)`` over two
    waves of the prompts reaches level >= 1, its second wave (decoded with
    speculation off) bit-equal to the greedy reference and its first
    teacher-forced within ``TF_GAP``."""
    import shutil
    import tempfile

    from learning_jax_sharding_tpu_torch.models.serving import AdmissionError
    from learning_jax_sharding_tpu_torch.robustness import (
        ChaosInjector,
        DegradationLadder,
        Fault,
    )
    from learning_jax_sharding_tpu_torch.telemetry import (
        FlightRecorder,
        MetricsRegistry,
        SLOMonitor,
        SLOTarget,
        TraceStore,
        Tracer,
    )
    from learning_jax_sharding_tpu_torch.utils import profiling

    cfg = dataclasses.replace(CONFIG_125M, decode_attention="blocked")
    params = Transformer(CONFIG_125M, device="cuda", seed=0).state_dict()
    prompts = engine_prompts()[:B]
    ref = [np.asarray(o) for o in ref_outs[:B]]
    out, bad = {}, []

    def same_as_ref(outs, rids=None):
        rids = range(len(ref)) if rids is None else rids
        return [i for i in rids if not np.array_equal(np.asarray(outs[i]), ref[i])]

    # (1) Telemetry attached.
    slo = SLOMonitor([SLOTarget(m, t, objective=o) for m, t, o in POLICY_SLO])
    serve = make_continuous_engine(cfg, **ENGINE_COMMON, paged_pages=ENGINE_PAGES,
                                   page_size=ENGINE_PAGE, prefix_cache=True,
                                   registry=MetricsRegistry(), tracer=Tracer(),
                                   recorder=FlightRecorder(), slo=slo)
    eng = serve.engine
    serve(params, prompts)                              # warm-up
    eng.flush_prefix_cache()
    # A serve numbers its requests 0..n-1: a fresh trace sink holds this
    # serve's journeys alone.
    eng.trace_sink = TraceStore(registry=eng.registry)
    torch.cuda.synchronize()
    reset_launches()
    forwards = eng.model_forwards
    outs = serve(params, prompts)
    torch.cuda.synchronize()
    launches = read_launches()
    calls = eng.model_forwards - forwards
    rec = eng.ledger.reconcile()
    rep = eng.ledger.window_report()
    b = rep["buckets"]
    host_ms = (rep["busy_s"] - b["device"] - b["compile"]) * 1e3 / calls
    paths = eng.trace_sink.completed()
    eng.trace_sink = None
    differ = same_as_ref(outs)
    want = cfg.num_layers * calls
    tele = dict(model_calls=calls, launches=launches, reconcile={k: rec[k] for k in (
        "ok", "wall_s", "sum_s", "residual_s", "eps")}, window_report=rep,
        telemetry_share=rep["telemetry_share"], host_ms_per_model_call=host_ms,
        device_ms_per_model_call=b["device"] * 1e3 / calls, tokens_equal=len(ref) - len(differ),
        stats=serve.last_stats, latency=serve.last_latency, slo=slo.snapshot()["targets"],
        critical_path_mean_s={st: statistics.mean(p["stages"][st] for p in paths)
                              for st in ("queue", "prefill", "decode", "stall")},
        recorder_events=len(eng.recorder.events()), tracer_events=len(eng.tracer.events))
    log(f"[engine] policies telemetry: paged + prefix (cold) serve, {calls} model calls, "
        f"decode attention {launches['decode_attention']} launches "
        f"({launches['decode_attention_paged']} paged; want {want}); tokens equal to the "
        f"[engine] phase's in {tele['tokens_equal']} of {len(ref)} requests; reconcile "
        f"{tele['reconcile']}; ledger buckets (s) "
        f"{ {k: round(v, 6) for k, v in b.items()} }, busy {rep['busy_s']:.6f} of wall "
        f"{rep['wall_s']:.6f} s, host share {rep['host_share']:.4f}, telemetry share "
        f"{rep['telemetry_share']:.6f}; the ledger books {host_ms:.3f} host ms and "
        f"{tele['device_ms_per_model_call']:.3f} device ms a model call; critical path means "
        f"(s) {tele['critical_path_mean_s']} on {card}")
    if differ:
        bad.append(f"telemetry serve: requests {differ} differ from the [engine] phase's")
    if (launches["decode_attention"] != want or launches["decode_attention_paged"] != want):
        bad.append(f"telemetry serve: decode attention {launches}, want {want} (all paged)")
    if not rec["ok"]:
        bad.append(f"telemetry serve: the ledger does not reconcile: {rec}")
    tele["profile"] = profile_summary(
        f"125M engine serve with telemetry, paged + prefix, per model call ({calls} a serve)",
        lambda: (eng.flush_prefix_cache(), serve(params, prompts)), calls,
        rep["wall_s"] * 1e3 / calls)
    logdir = tempfile.mkdtemp(prefix="engine_trace_")
    try:
        eng.flush_prefix_cache()
        for p in prompts:
            eng.add_request(p)
        with profiling.trace(logdir) as prof:
            eng.step(params)
            eng.step(params)
            torch.cuda.synchronize()
        while eng.has_work():
            eng.step(params)
        eng.pop_finished()
        text = open(f"{logdir}/trace.json").read()
        ranges = sorted({e.key for e in prof.key_averages() if e.key.startswith("engine.")})
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    tele["trace_ranges"] = ranges
    log(f"[engine] policies: profiling.trace of two steps holds the ranges {ranges}")
    for name in ("engine.refill_step", "engine.decode_block"):
        if name not in ranges or name not in text:
            bad.append(f"profiling.trace: no {name} range in the capture ({ranges})")
    out["telemetry"] = tele
    del serve, eng
    torch.cuda.empty_cache()

    # (2) The policies.
    pol = {}
    serve = make_continuous_engine(cfg, **ENGINE_COMMON)
    eng = serve.engine
    eng.add_request(prompts[0], rid=0, deadline_s=1e-6)
    eng.add_request(prompts[1], rid=1)
    done = {}
    while eng.has_work():
        eng.step(params)
        done.update(eng.pop_finished())
    status = {rid: getattr(r, "status", "ok") for rid, r in done.items()}
    pol["deadline"] = dict(status=status, evictions=eng.registry.get(
        "engine_deadline_evictions_total").value,
        deadline_miss_rate=eng.latency_stats()["deadline_miss_rate"])
    if status != {0: "deadline", 1: "ok"} or same_as_ref(done, [1]):
        bad.append(f"deadline: statuses {status}, request 1 equal to the reference: "
                   f"{not same_as_ref(done, [1])}")

    shed_eng = make_continuous_engine(cfg, **ENGINE_COMMON, max_queue=2).engine
    shed_eng.add_request(prompts[0])
    shed_eng.add_request(prompts[1])
    try:
        shed_eng.add_request(prompts[2])
        shed = None
    except AdmissionError as exc:
        shed = str(exc)
    shed_eng.close()
    pol["shed"] = dict(error=shed, shed_total=shed_eng.registry.get("engine_shed_total").value)
    if shed is None or pol["shed"]["shed_total"] != 1:
        bad.append(f"max_queue=2: {pol['shed']}")
    del shed_eng

    rec = FlightRecorder()
    for rid, p in enumerate(prompts):
        eng.add_request(p, rid=100 + rid)
    poison = 100 + POLICY_POISON
    t0 = time.perf_counter()
    with ChaosInjector(Fault("engine.dispatch", "hang", rid=poison, count=-1),
                       recorder=rec) as inj:
        done = {}
        while eng.has_work():
            eng.step(params)
            done.update(eng.pop_finished())
    seconds = time.perf_counter() - t0
    status = {rid: getattr(r, "status", "ok") for rid, r in done.items()}
    mates = {rid - 100: r for rid, r in done.items() if rid != poison}
    differ = same_as_ref(mates, sorted(mates))
    pol["quarantine"] = dict(
        status=status, quarantined=eng.registry.get("engine_quarantined_total").value,
        dispatch_faults=eng.registry.get("engine_dispatch_faults_total").value,
        injections=len(inj.injections), seconds=seconds,
        recovery_s=eng.ledger.window_buckets()["recovery"],
        batchmates_equal=len(mates) - len(differ))
    if (status[poison] != "poisoned" or pol["quarantine"]["quarantined"] != 1
            or any(v != "ok" for r, v in status.items() if r != poison) or differ):
        bad.append(f"quarantine: {pol['quarantine']}, batchmates differing {differ}")
    del serve, eng
    torch.cuda.empty_cache()

    spec = dict(ENGINE_COMMON, draft_config=cfg, num_draft=MODES_DRAFT,
                decode_block_steps=MODES_SPEC_ROUNDS)
    eng = make_continuous_engine(
        cfg, **spec, slo=SLOMonitor([SLOTarget("ttft", 1e-9, objective=0.5)]),
        degradation=DegradationLadder(patience=1)).engine
    for rid, p in enumerate(prompts + prompts):      # two waves
        eng.add_request(p, rid=rid)
    done, levels = {}, []
    while eng.has_work():
        eng.step(params, params)
        levels.append(eng.degradation_level)
        done.update(eng.pop_finished())
    wave1 = [done[i] for i in range(len(prompts))]
    wave2 = {i: done[i + len(prompts)] for i in range(len(prompts))}
    differ2 = same_as_ref(wave2)
    dense = Transformer(dataclasses.replace(cfg, param_dtype=torch.bfloat16), device="cuda",
                        seed=1).eval()
    dense.load_state_dict(params)
    gap1 = engine_gap(dense, wave1)
    del dense
    pol["degraded"] = dict(levels=levels, level=eng.degradation_level,
                           spec_disabled=eng._spec_disabled,
                           wave2_equal=len(prompts) - len(differ2),
                           wave1_equal=len(prompts) - len(same_as_ref(wave1)),
                           wave1_teacher_forced_gap=gap1, last_stats=eng.last_stats)
    if eng.degradation_level < 1 or not eng._spec_disabled or differ2 or not gap1 <= TF_GAP:
        bad.append(f"degraded speculation: {pol['degraded']}, second wave differing {differ2}")
    out["policies"] = pol
    log(f"[engine] policies: deadline {pol['deadline']}; shed {pol['shed']}; quarantine "
        f"{pol['quarantine']}; degraded speculation levels {levels}, speculation off "
        f"{eng._spec_disabled}, second wave equal to the greedy reference in "
        f"{pol['degraded']['wave2_equal']} of {len(prompts)}, first wave (speculative) in "
        f"{pol['degraded']['wave1_equal']}, its teacher-forced gap {gap1:.4f} on {card}")
    del eng
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"[engine] policies: {'; '.join(bad)}")
    return out


def _handoff_rows(pre, dec, params, prompts):
    """``prompts`` (ids 0, 1, ...) served disaggregated, by hand (the fleet
    router is slice F): each request prefilled and retired on ``pre``, its
    row exported, moved by ``fleet.kv_transfer.transfer_tree`` into
    ``dec``'s row layout (clipped at its valid length) once ``dec`` has a
    free slot, ingested and decoded there. → ``({rid: tokens}, [{rid,
    export_s, transfer_s, ingest_s, bytes, length}])``; each stage timed
    on the host clock up to a device synchronize."""
    from learning_jax_sharding_tpu_torch.fleet import transfer_tree

    dec.ensure_cache(params)
    dst, dims = dec.kv_row_shardings(), dec.kv_row_seq_dims()
    for i, p in enumerate(prompts):
        pre.add_request(p, rid=i)
    parked, out, moves, plans = [], {}, [], {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    while pre.has_work() or parked or dec.has_work():
        if pre.has_work():
            done = pre.step(params)
            fin = pre.pop_finished()
            for rid in done:
                (rows, length), export_s = timed(lambda rid=rid: pre.export_kv(rid))
                parked.append((rid, rows, length, int(np.asarray(fin[rid])[-1]), export_s))
        while parked and dec.free_slots():
            rid, rows, length, first, export_s = parked.pop(0)
            (moved, st), transfer_s = timed(lambda: transfer_tree(
                rows, dst, stop=length, seq_dims=dims, plan_cache=plans))
            _, ingest_s = timed(lambda: dec.ingest_kv(params, prompts[rid], first, moved,
                                                      rid=rid))
            moves.append(dict(rid=rid, length=length, bytes=st["bytes"],
                              segments=st["segments"], export_s=export_s,
                              transfer_s=transfer_s, ingest_s=ingest_s))
        if dec.has_work():
            dec.step(params)
        out.update(dec.pop_finished())
    return out, moves


def run_engine_handoff(ref_outs, card):
    """``[engine] handoff`` (slice 18): the engine's KV handoff, KV tier and
    weight swaps, at the 125M model's full width in bf16 with
    ``ENGINE_COMMON``'s shapes, on the ``[engine]`` phase's weights (seed 0)
    and its first ``B`` prompts. (1) Disaggregated serving: an unpaged
    prefill engine (``max_new_tokens=1``) retires each request, its row goes
    through ``export_kv`` → ``transfer_tree`` → ``ingest_kv`` into an
    unpaged decode engine, which decodes the rest; gates: tokens equal to
    the ``[engine]`` phase's (``ref_outs``) 8 of 8, decode attention once a
    layer per model call of either engine. (2) The KV tier: a paged +
    prefix engine serves cold, spills every retained page to host memory,
    fills them back and serves warm; gates: warm prefix hits 8 of 8 and
    equal tokens, a second spill of every page bit-equal to the first,
    decode attention's paged launches once a layer per model call. (3) The
    swap on that engine: a drain-mode ``swap_weights`` (the weights times
    1.01, version 1) staged with the slots full and 8 more queued, stepped
    with the old params, then a preempt-mode swap back to the weights
    (version 2); gates: nothing dropped, versions {0, 1} then {2}, each
    response equal to a solo serve under its version's weights (the
    reference for versions 0 and 2). Both engines' ledgers reconcile, with
    ``kv_handoff`` and ``swap`` seconds booked. Printed beside ``card``:
    export and ingest ms and MB a request, spill and fill ms and GB/s a
    page, stage ms and the swap's stall seconds."""
    cfg = dataclasses.replace(CONFIG_125M, decode_attention="blocked")
    params = Transformer(CONFIG_125M, device="cuda", seed=0).state_dict()
    prompts = engine_prompts()[:B]
    ref = [np.asarray(o) for o in ref_outs[:B]]
    out, bad = {}, []

    def differing(outs, want, rids):
        return [i for i in rids if not np.array_equal(np.asarray(outs[i]), want[i % B])]

    def counted(engines, fn):
        """``fn()`` with decode attention's counters zeroed before and read
        after → (its result, launches, the engines' model calls)."""
        before = [e.model_forwards for e in engines]
        torch.cuda.synchronize()
        reset_launches()
        got = fn()
        torch.cuda.synchronize()
        return got, read_launches(), sum(e.model_forwards for e in engines) - sum(before)

    # (1) Disaggregated serving.
    pre = make_continuous_engine(cfg, **dict(ENGINE_COMMON, max_new_tokens=1)).engine
    dec = make_continuous_engine(cfg, **ENGINE_COMMON).engine
    _handoff_rows(pre, dec, params, prompts[:1])                 # warm-up
    (tokens, moves), launches, calls = counted(
        [pre, dec], lambda: _handoff_rows(pre, dec, params, prompts))
    differ = differing(tokens, ref, range(B))
    want = cfg.num_layers * calls
    mean = lambda key: statistics.mean(m[key] for m in moves)  # noqa: E731
    dis = dict(model_calls=calls, launches={k: launches[k] for k in (
        "decode_attention", "decode_attention_paged", "decode_attention_tensor_core",
        "decode_attention_split")}, tokens_equal=B - len(differ),
        export_ms=mean("export_s") * 1e3, transfer_ms=mean("transfer_s") * 1e3,
        ingest_ms=mean("ingest_s") * 1e3, mb_per_request=mean("bytes") / 1e6,
        row_tokens=mean("length"), segments_per_request=mean("segments"),
        reconcile=[e.ledger.reconcile()["ok"] for e in (pre, dec)],
        kv_handoff_s=[e.ledger.window_buckets()["kv_handoff"] for e in (pre, dec)],
        moves=moves)
    log(f"[engine] handoff disaggregated: {B} requests prefilled on one engine and decoded "
        f"on another, {calls} model calls, decode attention {launches['decode_attention']} "
        f"launches (want {want}); tokens equal to the [engine] phase's in "
        f"{dis['tokens_equal']} of {B}; a request: export {dis['export_ms']:.3f} ms, "
        f"transfer {dis['transfer_ms']:.3f} ms, ingest {dis['ingest_ms']:.3f} ms, "
        f"{dis['mb_per_request']:.3f} MB over {dis['segments_per_request']:.1f} segments "
        f"({dis['row_tokens']:.0f} valid tokens) on {card}")
    if differ:
        bad.append(f"handoff: requests {differ} differ from the [engine] phase's")
    if launches["decode_attention"] != want or launches["decode_attention_paged"]:
        bad.append(f"handoff: decode attention {launches}, want {want} (none paged)")
    if not all(dis["reconcile"]) or not all(s > 0 for s in dis["kv_handoff_s"]):
        bad.append(f"handoff: ledgers {dis['reconcile']}, kv_handoff {dis['kv_handoff_s']}")
    out["disaggregated"] = dis
    del pre, dec
    torch.cuda.empty_cache()

    # (2) The KV tier.
    eng = make_continuous_engine(cfg, **ENGINE_COMMON, paged_pages=ENGINE_PAGES,
                                 page_size=ENGINE_PAGE, prefix_cache=True).engine
    eng.serve(params, prompts)                                    # warm-up
    eng.flush_prefix_cache()
    cold, launches, calls = counted([eng], lambda: eng.serve(params, prompts))
    keys = eng.retained_prefixes()
    spills, fills, first = [], [], {}
    for key in keys:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows, st = eng.spill_page(key, drop=True)
        spills.append((time.perf_counter() - t0, st["bytes"]))
        first[key] = rows
    for key in keys:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = eng.fill_page(key, first[key])
        torch.cuda.synchronize()
        fills.append((time.perf_counter() - t0, st["bytes"]))
    warm, warm_launches, warm_calls = counted([eng], lambda: eng.serve(params, prompts))
    hits = eng.last_stats["prefix_hits"]
    unequal = [i for i, key in enumerate(keys) if not all(
        torch.equal(a, b) for a, b in zip(first[key], eng.spill_page(key, drop=False)[0]))]
    tier = dict(
        pages=len(keys), page_mb=spills[0][1] / 1e6 if spills else None,
        spill_ms=statistics.mean(s for s, _ in spills) * 1e3,
        fill_ms=statistics.mean(s for s, _ in fills) * 1e3,
        spill_gb_s=sum(b for _, b in spills) / sum(s for s, _ in spills) / 1e9,
        fill_gb_s=sum(b for _, b in fills) / sum(s for s, _ in fills) / 1e9,
        warm_hits=hits, warm_equal=B - len(differing(warm, ref, range(B))),
        cold_equal=B - len(differing(cold, ref, range(B))), second_spill_unequal=unequal,
        launches=dict(cold=launches["decode_attention_paged"], cold_calls=calls,
                      warm=warm_launches["decode_attention_paged"], warm_calls=warm_calls),
        warm_stats=eng.last_stats)
    log(f"[engine] handoff tier: {len(keys)} retained pages of {tier['page_mb']:.3f} MB spilled "
        f"and filled back; a page: spill {tier['spill_ms']:.3f} ms "
        f"({tier['spill_gb_s']:.3f} GB/s), fill {tier['fill_ms']:.3f} ms "
        f"({tier['fill_gb_s']:.3f} GB/s); warm serve prefix hits {hits} of {B}, tokens equal "
        f"in {tier['warm_equal']} (cold {tier['cold_equal']}); second spill unequal pages "
        f"{unequal}; paged decode attention {tier['launches']} on {card}")
    if hits != B or tier["warm_equal"] != B or tier["cold_equal"] != B or unequal or not keys:
        bad.append(f"tier: {tier}")
    for k in ("cold", "warm"):
        if tier["launches"][k] != cfg.num_layers * tier["launches"][f"{k}_calls"]:
            bad.append(f"tier: {k} serve's paged decode attention {tier['launches']}")

    # (3) The swap, on the same engine.
    new = {k: v * 1.01 for k, v in params.items()}
    solo = make_continuous_engine(cfg, **ENGINE_COMMON)
    solo_new = solo(new, prompts)
    del solo
    for rid, p in enumerate(prompts + prompts):
        eng.add_request(p, rid=100 + rid)
    eng.step(params)                                    # 8 admitted, 8 queued
    busy = [r for r in eng._req if r >= 0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = eng.swap_weights(new, version=1)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    staged_bytes = eng.registry.get("engine_swap_bytes_total").value
    done = {}

    def drive():
        while eng.has_work():
            eng.step(params)                            # stale params: the installed win
            done.update(eng.pop_finished())

    _, launches, calls = counted([eng], drive)
    stall = eng.registry.get("engine_swap_stall_seconds")
    stall_s, stall_n = stall.sum, stall.count           # the drain swap's alone
    versions = {rid: eng.finished_versions[rid] for rid in done}
    old = [r - 100 for r, v in versions.items() if v == 0]
    fresh = [r - 100 for r, v in versions.items() if v == 1]
    by_rid = {r - 100: t for r, t in done.items()}
    wrong = differing(by_rid, ref, old) + differing(by_rid, [np.asarray(o) for o in solo_new],
                                                    fresh)
    drops = [r for r, t in done.items() if not isinstance(t, np.ndarray)]
    for rid, p in enumerate(prompts):
        eng.add_request(p, rid=200 + rid)
    eng.step()
    preempted = eng.swap_weights(params, version=2, mode="preempt")
    done2 = {}
    while eng.has_work():
        eng.step()
        done2.update(eng.pop_finished())
    versions2 = {eng.finished_versions[r] for r in done2}
    wrong2 = differing({r - 200: t for r, t in done2.items()}, ref, range(B))
    rec = eng.ledger.reconcile()
    buckets = eng.ledger.window_buckets()
    swap = dict(staged=staged, stage_ms=stage_ms, stall_s=stall_s, stall_observations=stall_n,
                busy_at_stage=len(busy),
                versions=sorted(set(versions.values())), requests=len(done), drops=drops,
                old=len(old), new=len(fresh), differing=wrong, preempt_staged=preempted,
                preempt_versions=sorted(versions2), preempt_differing=wrong2,
                swap_bytes=staged_bytes,
                decode_attention_paged=launches["decode_attention_paged"], model_calls=calls,
                reconcile={k: rec[k] for k in ("ok", "wall_s", "sum_s", "residual_s", "eps")},
                kv_handoff_s=buckets["kv_handoff"], swap_s=buckets["swap"])
    log(f"[engine] handoff swap: drain-mode stage {stage_ms:.3f} ms "
        f"({swap['swap_bytes'] / 1e6:.1f} MB staged), stall {swap['stall_s']:.6f} s "
        f"(stage to commit, {len(busy)} requests in flight); {len(done)} responses, "
        f"{len(drops)} dropped, versions {swap['versions']} ({len(old)} old, {len(fresh)} new), "
        f"{len(wrong)} differing from a solo serve under their version; preempt-mode swap "
        f"versions {swap['preempt_versions']}, {len(wrong2)} differing; ledger reconcile "
        f"{swap['reconcile']}, kv_handoff {swap['kv_handoff_s']:.6f} s, swap "
        f"{swap['swap_s']:.6f} s on {card}")
    if (not staged or stall_n != 1 or drops or swap["versions"] != [0, 1] or wrong
            or len(done) != 2 * B
            or not preempted or swap["preempt_versions"] != [2] or wrong2):
        bad.append(f"swap: {swap}")
    if swap["decode_attention_paged"] != cfg.num_layers * calls:
        bad.append(f"swap: paged decode attention {swap['decode_attention_paged']} for "
                   f"{calls} model calls")
    if not rec["ok"] or not swap["kv_handoff_s"] > 0 or not swap["swap_s"] > 0:
        bad.append(f"swap: ledger {swap['reconcile']}, kv_handoff {swap['kv_handoff_s']}, "
                   f"swap {swap['swap_s']}")
    out["tier"], out["swap"] = tier, swap
    out["launches"] = (dis["launches"]["decode_attention"] + tier["launches"]["cold"]
                       + tier["launches"]["warm"] + swap["decode_attention_paged"])
    del eng
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"[engine] handoff: {'; '.join(bad)}")
    return out


def _shards(layout):
    """The (data, model) coordinates of a layout, rank order."""
    return [(i, j) for i in range(layout[0]) for j in range(layout[1])]


def _cut(x, dims, layout, coord):
    """Shard ``coord`` of ``x`` whose dims ``dims`` = {dim: 0 (data) or 1
    (model)} split over the layout's axes."""
    for dim, axis in dims.items():
        n = x.shape[dim] // layout[axis]
        x = x.narrow(dim, coord[axis] * n, n)
    return x


def _stitch(parts, dims, layout, like):
    """The whole tensor from every shard's piece (rank order)."""
    out = torch.empty_like(like)
    for coord, part in zip(_shards(layout), parts):
        _cut(out, dims, layout, coord).copy_(part)
    return out


def _held(label, got, want, tol, bit_equal=False):
    err = rel_err(label, got, want)
    same = bool(torch.equal(got, want))
    if bit_equal and not same:
        raise AssertionError(f"[mesh] {label}: stitched shards not bit-equal to the whole")
    if not err[0] <= tol:
        raise AssertionError(f"[mesh] {label}: stitched shards off the whole by {err[0]} > {tol}")
    return dict(max_rel=err[0], max_abs=err[1], bit_equal=same)


def shard_rows(name, rows):
    """The per-shard phase's rows of one kernel of the kernels line (the
    q/k/v triple and the whole FF take no tensor-parallel path)."""
    if name.startswith(("flash", "fused_norm")):
        return rows[name.rsplit("_", 1)[0] if name.startswith("fused") else "flash"]
    if name == "decode_attention":
        return rows["decode_attention"]
    if name in ("int4_matmul", "int4_matmul_w4a8"):
        return {k: v for k, v in rows["int4"].items()
                if k.endswith(" w4a8") == (name == "int4_matmul_w4a8")}
    return None


def run_mesh_shards(gen, card):
    """Every shard of each ``MESH_LAYOUTS`` (data, model) layout of the mesh
    paths' main shapes through the kernel wrappers, one after another on the
    card, stitched and held to the whole: flash forward and backward at the
    train shape (batch over data, heads over model), the fused norm forward
    and backward at the train step's rows of a shard (batch over data,
    sequence over model: RULES_DP_TP_SP's activations; dgamma/dbeta the sum
    of the shards'), decode attention at TP generate's prefill and token
    step (batch and heads), the int4 matmuls at TP generate's token step,
    w4a16 and w4a8: the column-parallel sites (q/k/v, FF up, lm_head) on a
    column slice, the row-parallel ones (out, FF down) on the gathered
    activation rows with the weights whole. Each shard's launches are
    counted by design and held to the rule at its shape."""
    bf16 = torch.bfloat16
    sms = mm4._sm_count(torch.cuda.current_device())
    cfg = CONFIG_125M
    n, h, m = cfg.num_heads, cfg.head_dim, cfg.features
    rows_out = {}
    for layout in MESH_LAYOUTS:
        tag = f"{layout[0]}x{layout[1]}"
        res = rows_out[tag] = {}
        shards = _shards(layout)

        # Flash at the train shape: q, k, v (B, S, N, H), batch over data,
        # heads over model.
        q, k, v, dout = (randn(gen, TRAIN_B, TRAIN_S, n, h, dtype=bf16) for _ in range(4))
        whole = [t.detach().requires_grad_() for t in (q, k, v)]
        o = flash.flash_attention(*whole, causal=True)
        o.backward(dout)
        want = [o.detach()] + [t.grad for t in whole]
        dims = {0: 0, 2: 1}
        parts, per = [], []
        for coord in shards:
            loc = [_cut(t, dims, layout, coord).detach().contiguous().requires_grad_()
                   for t in (q, k, v)]
            before = dict(flash.flash_attention.launches)
            o = flash.flash_attention(*loc, causal=True)
            o.backward(_cut(dout, dims, layout, coord).contiguous())
            torch.cuda.synchronize()
            per.append({key: flash.flash_attention.launches[key] - before[key] for key in before})
            parts.append([o.detach()] + [t.grad for t in loc])
        for launches in per:
            if launches != dict.fromkeys(FLASH_LAUNCH_KEYS, 1):
                raise AssertionError(f"[mesh] {tag} flash shard launched {launches}")
        res["flash"] = {name: _held(f"{tag} flash {name}", _stitch([p[i] for p in parts], dims,
                                                                   layout, want[i]),
                                    want[i], TOL[bf16])
                        for i, name in enumerate(("out", "dq", "dk", "dv"))}
        res["flash"]["launches_per_shard"] = per[0]
        res["flash"]["shard_shape"] = list(parts[0][0].shape)
        log(f"[mesh] {tag} flash: shard {res['flash']['shard_shape']}, launches a shard "
            f"{per[0]} (design {flash._fwd_design(bf16, h)} / {flash._bwd_design(bf16, h)}); "
            + ", ".join(f"{k} {res['flash'][k]['max_rel']:.2e}"
                        + (" bit-equal" if res['flash'][k]['bit_equal'] else "")
                        for k in ("out", "dq", "dk", "dv")))
        del q, k, v, dout, whole, o, want, parts

        # Fused norm at the train rows: x, resid (B, S, M).
        x, r, dy, dr = (randn(gen, TRAIN_B, TRAIN_S, m, dtype=bf16) for _ in range(4))
        g = (1 + 0.1 * torch.randn(m, generator=gen, device="cuda"))
        b_ = 0.1 * torch.randn(m, generator=gen, device="cuda")
        ins = [x, r, g, b_]

        def fused(x_, r_, g_, b2):
            t = [x_.detach().contiguous().requires_grad_(), r_.detach().contiguous(),
                 g_.detach().requires_grad_(), b2.detach().requires_grad_()]
            y, nr = norm_ops.fused_residual_norm(t[0], t[1], t[2], t[3])
            return t, y, nr

        t, y, nr = fused(*ins)
        torch.autograd.backward((y, nr), (dy, dr))
        want = dict(y=y.detach(), r=nr.detach(), dx=t[0].grad, dgamma=t[2].grad,
                    dbeta=t[3].grad)
        dims = {0: 0, 1: 1}
        got = {key: [] for key in want}
        per = []
        for coord in shards:
            before = dict(norm_ops.fused_residual_norm.launches)
            t, y, nr = fused(_cut(x, dims, layout, coord), _cut(r, dims, layout, coord), g, b_)
            torch.autograd.backward((y, nr), (_cut(dy, dims, layout, coord).contiguous(),
                                              _cut(dr, dims, layout, coord).contiguous()))
            torch.cuda.synchronize()
            per.append({key: norm_ops.fused_residual_norm.launches[key] - before[key]
                        for key in before})
            for key, val in (("y", y), ("r", nr), ("dx", t[0].grad), ("dgamma", t[2].grad),
                             ("dbeta", t[3].grad)):
                got[key].append(val.detach())
        for launches in per:
            if launches != {"fwd": 1, "fwd_nostats": 0, "bwd": 1}:
                raise AssertionError(f"[mesh] {tag} fused norm shard launched {launches}")
        shard_rows = TRAIN_B * TRAIN_S // (layout[0] * layout[1])
        res["fused_norm"] = {key: _held(f"{tag} fused_norm {key}",
                                        _stitch(got[key], dims, layout, want[key]),
                                        want[key], NORM_TOL[bf16], bit_equal=key != "dx")
                             for key in ("y", "r", "dx")}
        for key in ("dgamma", "dbeta"):
            res["fused_norm"][key] = _held(f"{tag} fused_norm {key}",
                                           torch.stack(got[key]).sum(0), want[key], 1e-4)
        res["fused_norm"].update(launches_per_shard=per[0], shard_rows=shard_rows,
                                 design={"fwd": norm_ops._design(shard_rows, m, bf16),
                                         "bwd": norm_ops._design(shard_rows, m, bf16, True)})
        log(f"[mesh] {tag} fused norm: {shard_rows} rows a shard, launches a shard {per[0]}, "
            f"design {res['fused_norm']['design']}; y/r bit-equal, dx "
            f"{res['fused_norm']['dx']['max_rel']:.2e}, dgamma "
            f"{res['fused_norm']['dgamma']['max_rel']:.2e} (sum of the shards')")
        del x, r, dy, dr, t, y, nr, want, got

        # Decode attention at TP generate's shapes (blocked cache).
        length = cfg.max_seq_len
        res["decode_attention"] = {}
        for name, s_q, index in (("prefill", PROMPT, 0), ("token step", 1, PROMPT + NEW // 2)):
            qd = randn(gen, B, s_q, n, h, dtype=bf16)
            kc, vc = (randn(gen, B, n, length, h, dtype=bf16) for _ in range(2))
            idx = torch.tensor(index, dtype=torch.int32, device="cuda")
            want = decode_attention(qd, kc, vc, idx)
            parts, per, plans = [], [], []
            for coord in shards:
                ql = _cut(qd, {0: 0, 2: 1}, layout, coord).contiguous()
                kl, vl = (_cut(c, {0: 0, 1: 1}, layout, coord).contiguous() for c in (kc, vc))
                reset_launches()
                parts.append(decode_attention(ql, kl, vl, idx))
                torch.cuda.synchronize()
                lz = read_launches()
                per.append({key: lz[key] for key in ("decode_attention",
                                                     "decode_attention_tensor_core",
                                                     "decode_attention_split")})
                plan = da._plan(bf16, ql.shape[0], s_q, ql.shape[2], kl.shape[1], h, length)
                plans.append(plan)
                wanted = {"decode_attention": 1,
                          "decode_attention_tensor_core": int(plan[0] == "tensor_core"),
                          "decode_attention_split": int(plan[1] > 1)}
                if per[-1] != wanted:
                    raise AssertionError(f"[mesh] {tag} decode attention {name} shard launched "
                                         f"{per[-1]}, the rule {plan} wants {wanted}")
            row = _held(f"{tag} decode attention {name}",
                        _stitch(parts, {0: 0, 2: 1}, layout, want), want, TOL[bf16])
            row.update(launches_per_shard=per[0], design=f"{plans[0][0]}/{plans[0][1]}",
                       whole_design="{}/{}".format(*da._plan(bf16, B, s_q, n, n, h, length)[:2]),
                       shard_shape=list(parts[0].shape))
            res["decode_attention"][name] = row
            log(f"[mesh] {tag} decode attention {name}: shard q {row['shard_shape']}, design "
                f"{row['design']} (whole {row['whole_design']}), launches a shard "
                f"{per[0]}; {row['max_rel']:.2e} of the largest |ref|")
        del qd, kc, vc, want, parts

        # int4 at TP generate's token step (M = B rows, B / data a shard).
        res["int4"] = {}
        sites = {"qkv (column)": (m, m, True), "ff up (column)": (m, cfg.hidden, True),
                 "lm_head (column)": (m, cfg.vocab_size, True),
                 "out (row)": (m, m, False), "ff down (row)": (cfg.hidden, m, False)}
        for site, (kk, nn_, column) in sites.items():
            node = int4_weight(gen, kk, nn_, 128)
            wq4, wsc = node["q4"], node["scale"]
            xs = randn(gen, B, kk, dtype=bf16)
            for w4a8 in (False, True):
                want = mm4.int4_matmul(xs, wq4, wsc, group=128, w4a8=w4a8)
                parts, per, variants = [], [], []
                for coord in shards:
                    xl = _cut(xs, {0: 0}, layout, coord).contiguous()
                    ql, sl = wq4, wsc
                    if column:
                        ql, sl = (_cut(t, {1: 1}, layout, coord).contiguous() for t in (wq4, wsc))
                    reset_launches()
                    parts.append(mm4.int4_matmul(xl, ql, sl, group=128, w4a8=w4a8))
                    torch.cuda.synchronize()
                    key = "int4_matmul_w4a8" if w4a8 else "int4_matmul"
                    lz = read_launches()
                    per.append({d: lz[f"{key}{d}"] for d in ("", "_tensor_core", "_small_m")})
                    variant = mm4._variant(xl.shape[0], kk, ql.shape[1], sl.shape[0], 128, bf16,
                                           w4a8, sms)
                    variants.append(variant)
                    wanted = {"": 1, "_tensor_core": int(variant == "tensor_core"),
                              "_small_m": int(variant == "small_m")}
                    if per[-1] != wanted:
                        raise AssertionError(f"[mesh] {tag} int4 {site} shard launched "
                                             f"{per[-1]}, the rule ({variant}) wants {wanted}")
                dims = {0: 0, 1: 1} if column else {0: 0}
                row = _held(f"{tag} int4 {site}{' w4a8' if w4a8 else ''}",
                            _stitch(parts, dims, layout, want), want,
                            TOL[bf16], bit_equal=w4a8)
                splits = (mm4._splits(parts[0].shape[0], kk, parts[0].shape[1], 1,
                                      wsc.shape[0], 128, sms, w4a8)
                          if variants[0] == "small_m" else None)
                row.update(launches_per_shard={k or "total": c for k, c in per[0].items()},
                           variant=variants[0], splits=splits,
                           whole_variant=mm4._variant(B, kk, nn_, wsc.shape[0], 128, bf16, w4a8,
                                                      sms),
                           shard_n=parts[0].shape[1] if column else nn_)
                res["int4"][f"{site}{' w4a8' if w4a8 else ''}"] = row
                log(f"[mesh] {tag} int4 {site}{' w4a8' if w4a8 else ''}: shard "
                    f"({xs.shape[0] // layout[0]}, {kk}) x ({kk}, {row['shard_n']}), "
                    f"{row['variant']}{f'/{splits}' if splits else ''} (whole "
                    f"{row['whole_variant']}); {row['max_rel']:.2e}"
                    + (" bit-equal" if row["bit_equal"] else ""))
    torch.cuda.synchronize()
    return rows_out


# ---------------------------------------------------------------------------
# Slice 22: sequence-parallel attention and the routed MoE feed-forward
# ---------------------------------------------------------------------------

# [train] sequence parallel: bench.py::bench_longcontext's shape (125M, 6
# heads x 128, S=8192, b=2, causal) on a (2, 2) data x model mesh of thread
# ranks under RULES_DP_SP (the sequence over model).
SP_FIELDS = dict(num_heads=6, head_dim=128, max_seq_len=8192)
SP_B, SP_S, SP_SHAPE = 2, 8192, (2, 2)
# The ring keeps fp32 (1, 6, 4096, 4096) score blocks (~400 MB) of every hop
# for its backward: tens of GB a rank over 12 layers, four ranks on one card.
# Its step runs under remat (bit-equal to the step without since slice 20),
# so one layer's blocks live at a time.
SP_LR = 3e-4
# [train] moe: bench.py::bench_moe_125m (E=8, top-2, capacity 1.25, the
# scatter dispatch, b=4, s=1024, sgd(3e-4), fused loss, 2 steps a call).
MOE_FIELDS = dict(num_experts=8, moe_top_k=2, moe_capacity_factor=1.25)
MOE_B, MOE_STEPS, MOE_LR = 4, 2, 3e-4
# tests/test_moe.py::TestSortDispatch's bounds (outputs, aux loss, gradients).
MOE_SORT_TOL = dict(out=(1e-5, 1e-5), aux=1e-6, grad=(2e-4, 2e-4))
# tests/test_moe.py::TestAllToAllDispatch's bounds (:324 outputs, :354 grads).
MOE_A2A_TOL = dict(out=(1e-5, 1e-5), grad=(2e-4, 2e-4))
MOE_A2A_SHAPE = (2, 1)
# [generate] moe: b=8, a 128-token prompt, +32, greedy, bf16.
MOE_GEN_NEW = 32


def _sp_cfg(**fields):
    return dataclasses.replace(CONFIG_125M, **SP_FIELDS, **fields)


def _rel_errors(model, refs) -> dict:
    """Each parameter's gradient (whole) against each reference's in
    ``refs`` (``{name: {param: grad}}``): relative Frobenius errors."""
    out = {ref: {} for ref in refs}
    for name, p in model.named_parameters():
        g = (p.grad.full_tensor() if hasattr(p.grad, "full_tensor") else p.grad).float()
        for ref, grads in refs.items():
            out[ref][name] = ((g - grads[name]).norm() / grads[name].norm()).item()
    return out


def _worst(rel: dict) -> tuple[str, float]:
    name = max(rel, key=rel.get)
    return name, rel[name]


def _sp_rank(mesh, strategy, batch, refs):
    """A rank of ``[train] sequence parallel``: one counted step of the
    strategy from the one-card step's weights (seed 0), then one timed
    step; the ring's collectives of one forward."""
    import torch.distributed as dist

    from learning_jax_sharding_tpu_torch.ops.ring_attention import make_ring_attn_fn
    from learning_jax_sharding_tpu_torch.ops.ulysses import make_ulysses_attn_fn
    from learning_jax_sharding_tpu_torch.parallel import logical
    from learning_jax_sharding_tpu_torch.parallel.hlo import counting_permutes

    rules = logical.RULES_DP_SP
    inner_shapes = []
    if strategy == "ring":
        fields = dict(attn_fn=make_ring_attn_fn(mesh, rules), remat=True)
    else:
        flash_fn = flash.make_flash_attn_fn()

        def counted_flash(q, k, v, *, causal=False):
            inner_shapes.append(tuple(q.shape))
            return flash_fn(q, k, v, causal=causal)

        fields = dict(attn_fn=make_ulysses_attn_fn(mesh, rules, attn_fn=counted_flash))
    state = sharded_train_state(Transformer(_sp_cfg(**fields), device="cuda", seed=0),
                                sgd(SP_LR), mesh=mesh, rules=rules)
    step = make_train_step(mesh=mesh, rules=rules, **TRAIN_LOSS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counting_permutes() as hops:
        _, loss = step(state, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    rel = _rel_errors(state.model, refs)
    shapes = list(inner_shapes)
    losses = [None] * dist.get_world_size()
    dist.all_gather_object(losses, float(loss))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    return dict(losses=losses, rel=rel, first_s=first_s, step_s=time.perf_counter() - t0,
                inner_shapes=shapes, hops=hops["collective-permute"],
                peak=torch.cuda.max_memory_allocated())


def run_seq_parallel_path(gen, card):
    """``[train] sequence parallel``: one train step with ring attention
    and one with Ulysses over the flash kernels, each on a (2, 2) mesh of
    four thread ranks, against a one-card step at the same shape and
    weights computing attention with the same arithmetic: Ulysses against
    the flash step, the ring (an fp32 online softmax) against the step with
    the dense fp32-softmax attention (under remat). Gates: the loss (1e-2
    relative) and every parameter's gradient (5e-2 relative Frobenius),
    every rank's loss equal; Ulysses' flash forwards on each rank 12 a step
    at (1, 8192, 3, 128) and the kernels' launches 4 x 12 each a step; the
    ring's hops 2 x (n - 1) a layer a forward, counted as
    collective-permutes over its step (a forward, remat's recompute, the
    gradients' hops back). The dense and the ring steps' distance from the
    flash step is printed beside (in bf16 at S=8192 the flash kernel's
    rounding of p alone moves the attention weights' gradients by about
    5e-2). ms a step of each."""
    from learning_jax_sharding_tpu_torch.parallel import run_on_threads

    layers = CONFIG_125M.num_layers
    tokens = torch.randint(0, CONFIG_125M.vocab_size, (SP_B, SP_S + 1), generator=gen,
                           device="cuda")
    batch = {"inputs": tokens[:, :-1].contiguous(), "targets": tokens[:, 1:].contiguous()}
    step = make_train_step(**TRAIN_LOSS)
    refs, ref_losses = {}, {}
    for name, fields in (("dense", dict(attn_fn=None, remat=True)),
                         ("flash", dict(attn_fn=flash.make_flash_attn_fn()))):
        state = sharded_train_state(Transformer(_sp_cfg(**fields), device="cuda", seed=0),
                                    sgd(SP_LR))
        ref_losses[name] = float(step(state, batch)[1])
        refs[name] = {n: p.grad.detach().float().clone()
                      for n, p in state.model.named_parameters()}
        if name == "dense":
            del state
    ref_loss = ref_losses["flash"]
    floor = _worst({n: ((g - refs["flash"][n]).norm() / refs["flash"][n].norm()).item()
                    for n, g in refs["dense"].items()})
    log(f"[train] sequence parallel: one card, dense (remat) vs flash: loss "
        f"{ref_losses['dense']:.6f} vs {ref_loss:.6f}; worst grad rel Frobenius err "
        f"{floor[1]:.3e} ({floor[0]}; not gated: bf16 rounding of the two attentions)")
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    one_ms = min(secs) * 1e3
    del state, step
    torch.cuda.empty_cache()
    log(f"[train] sequence parallel: one-card flash step b={SP_B} S={SP_S} 6 heads x 128, "
        f"loss {ref_loss:.6f}, {one_ms:.3f} ms/step (best of 2) on {card}")
    out = dict(one_card=dict(loss=ref_loss, dense_loss=ref_losses["dense"], ms_per_step=one_ms,
                             dense_vs_flash_worst_grad=list(floor)))
    n = SP_SHAPE[1]
    for strategy in ("ring", "ulysses"):
        _reset_kernel_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = run_on_threads(_sp_rank, SP_SHAPE, ("data", "model"), device_type="cuda",
                             args=(strategy, batch, refs))
        torch.cuda.synchronize()
        launches = {k: v for k, v in _kernel_launches().items()
                    if k.startswith("flash_") and v}
        against = "dense" if strategy == "ring" else "flash"
        diff = abs(res["losses"][0] - ref_losses[against]) / abs(ref_losses[against])
        worst, err = _worst(res["rel"][against])
        flash_worst = _worst(res["rel"]["flash"])
        label = f"[train] sequence parallel, {strategy}{' (remat)' if strategy == 'ring' else ''}"
        log(f"{label}: losses a rank {[round(x, 6) for x in res['losses']]} vs the one-card "
            f"{against} step's {ref_losses[against]:.6f} (rel diff {diff:.2e}, tol "
            f"{STEP_LOSS_TOL:g}); worst grad rel Frobenius err {err:.3e} ({worst}, tol "
            f"{STEP_GRAD_TOL:g}); against the flash step {flash_worst[1]:.3e} "
            f"({flash_worst[0]}); flash launches {launches}; peak "
            f"{res['peak'] / 2**30:.2f} GiB (4 ranks)")
        if not diff <= STEP_LOSS_TOL:
            raise AssertionError(f"{strategy}: loss {res['losses'][0]} vs {ref_losses[against]}")
        if not err <= STEP_GRAD_TOL:
            raise AssertionError(f"{strategy}: grad of {worst} off by {err}")
        if len(set(res["losses"])) != 1:
            raise AssertionError(f"{strategy}: the ranks' losses differ: {res['losses']}")
        row = dict(loss=res["losses"][0], against=against, rel_loss_diff=diff,
                   worst_grad_rel_err=err, worst_grad=worst,
                   vs_flash_worst_grad=list(flash_worst), first_step_ms=res["first_s"] * 1e3,
                   ms_per_step=res["step_s"] * 1e3, peak_bytes=res["peak"], launches=launches)
        if strategy == "ring":
            # A forward's hops, again in remat's recompute, and the
            # gradients' hops back: three times (n - 1) x 2 x layers.
            want = (n - 1) * 2 * layers
            log(f"{label}: {res['hops']} collective-permutes in the counted step (want 3 x "
                f"{want}: {want} a forward, recomputed once, and the gradients' hops back); "
                f"no flash launch")
            if res["hops"] != 3 * want or launches:
                raise AssertionError(f"ring: {res['hops']} hops in a step, launches {launches}")
            row["step_hops"] = res["hops"]
        else:
            shape = (SP_B // SP_SHAPE[0], SP_S, SP_FIELDS["num_heads"] // n,
                     SP_FIELDS["head_dim"])
            # The counted step and the timed one, four ranks each.
            want = {f"flash_{k}": 2 * 4 * layers for k in FLASH_LAUNCH_KEYS}
            log(f"{label}: rank 0's flash forwards {len(res['inner_shapes'])} at "
                f"{sorted(set(res['inner_shapes']))} (want {layers} at {shape})")
            if res["inner_shapes"] != [shape] * layers or launches != want:
                raise AssertionError(f"ulysses: rank 0 flash calls {res['inner_shapes']}, "
                                     f"launches {launches}, want {want}")
            row["rank_flash_shape"] = list(shape)
        log(f"[time] sequence parallel {strategy} step b={SP_B} S={SP_S} on four thread ranks "
            f"of one card: {row['ms_per_step']:.1f} ms/step (first step "
            f"{row['first_step_ms']:.1f}; one card {one_ms:.1f}; thread ranks time DTensor's "
            f"dispatch and the interpreter more than the links) on {card}")
        out[strategy] = row
        torch.cuda.empty_cache()
    del refs
    return out


def _moe_cfg(**fields):
    return dataclasses.replace(CONFIG_125M, **{"attn_fn": flash.make_flash_attn_fn(),
                                               **MOE_FIELDS, **fields})


def _moe_layer(dispatch, seed, **kw):
    """The 125M MoE layer's widths (768 -> 3072, E=8, top-2, capacity 1.25),
    fp32."""
    return moe_models.MoEFeedForward(
        CONFIG_125M.features, CONFIG_125M.hidden, num_experts=MOE_FIELDS["num_experts"],
        top_k=MOE_FIELDS["moe_top_k"], capacity_factor=MOE_FIELDS["moe_capacity_factor"],
        dtype=torch.float32, dispatch=dispatch, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(seed), **kw)


def _within(label, got, want, rtol, atol):
    err = ((got - want).abs() - rtol * want.abs()).max().item()
    if not err <= atol:
        raise AssertionError(f"{label}: off by {err} past rtol {rtol}")
    return (got - want).abs().max().item()


def check_moe_dispatch(gen):
    """The scatter dispatch against the einsum one at the 125M MoE layer's
    widths in fp32 (b=4, s=1024): outputs, aux loss and gradients within
    TestSortDispatch's bounds."""
    x = torch.randn(MOE_B, TRAIN_S, CONFIG_125M.features, generator=gen, device="cuda")
    runs = {}
    for dispatch in ("einsum", "scatter"):
        layer = _moe_layer(dispatch, 0)
        with moe_models.collecting("losses") as aux:
            out = layer(x)
        torch.sin(out).sum().backward()
        runs[dispatch] = (out.detach(), aux[0].detach(),
                          {n: p.grad for n, p in layer.named_parameters()})
    (oe, ae, ge), (os_, as_, gs) = runs["einsum"], runs["scatter"]
    errs = dict(out=_within("scatter vs einsum out", os_, oe, *MOE_SORT_TOL["out"]),
                aux=abs(as_ - ae).item() / abs(ae).item())
    if not errs["aux"] <= MOE_SORT_TOL["aux"]:
        raise AssertionError(f"scatter vs einsum aux: {as_} vs {ae}")
    errs["grad"] = max(_within(f"scatter vs einsum grad {n}", gs[n], g, *MOE_SORT_TOL["grad"])
                       for n, g in ge.items())
    log(f"[train] moe: scatter vs einsum at the 125M MoE layer (fp32, {MOE_B}x{TRAIN_S} "
        f"tokens): max abs err out {errs['out']:.2e}, aux rel {errs['aux']:.2e}, grads "
        f"{errs['grad']:.2e} (TestSortDispatch's bounds {MOE_SORT_TOL})")
    return errs


def run_moe_train_path(gen, card):
    """``[train] moe``: the 125M MoE train step (E=8, top-2, scatter, b=4,
    sgd, fused loss): one step against the einsum dispatch's on the same
    weights (the step check's bounds), the 2-step call's flash launches
    (12 + 12 + 12 a step) and descent, a step with the aux losses (its
    loss above ln V and above the same weights' loss without them); ms a
    step, tok/s and activated MFU beside the dense 125M step's under the
    same harness (b=4, sgd)."""
    layer_errs = check_moe_dispatch(gen)
    tokens = torch.randint(0, CONFIG_125M.vocab_size, (MOE_B, TRAIN_S + 1), generator=gen,
                           device="cuda")
    batch = {"inputs": tokens[:, :-1].contiguous(), "targets": tokens[:, 1:].contiguous()}
    step = make_train_step(**TRAIN_LOSS)
    first = {}
    for dispatch in ("einsum", "scatter"):
        state = sharded_train_state(Transformer(_moe_cfg(moe_dispatch=dispatch), device="cuda",
                                                seed=0), sgd(MOE_LR))
        loss = float(step(state, batch)[1])
        grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
        first[dispatch] = (loss, grads)
        if dispatch == "einsum":
            del state
    (le, ge), (ls, gs) = first["einsum"], first["scatter"]
    rel = {n: ((gs[n] - g).norm() / g.norm()).item() for n, g in ge.items()}
    worst = max(rel, key=rel.get)
    diff = abs(ls - le) / abs(le)
    log(f"[train] moe: scatter vs einsum, one 125M step: loss {ls:.6f} vs {le:.6f} (rel diff "
        f"{diff:.2e}, tol {STEP_LOSS_TOL:g}); worst grad rel Frobenius err {rel[worst]:.3e} "
        f"({worst}, tol {STEP_GRAD_TOL:g})")
    if not diff <= STEP_LOSS_TOL or not rel[worst] <= STEP_GRAD_TOL:
        raise AssertionError(f"moe scatter vs einsum step: loss {ls} vs {le}, {worst} {rel[worst]}")
    del first, ge, gs

    multi = make_train_step(steps_per_call=MOE_STEPS, **TRAIN_LOSS)
    stacked = {k: v.expand(MOE_STEPS, *v.shape) for k, v in batch.items()}
    torch.cuda.synchronize()
    _reset_kernel_launches()
    _, losses = multi(state, stacked)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _kernel_launches().items() if k.startswith("flash_") and v}
    want = {f"flash_{k}": MOE_STEPS * CONFIG_125M.num_layers for k in FLASH_LAUNCH_KEYS}
    losses = [ls, *losses.tolist()]
    log(f"[train] moe: {MOE_STEPS}-step call: launches {launches} (want {want}); losses "
        f"{[round(x, 5) for x in losses]} over three steps")
    if launches != want:
        raise AssertionError(f"moe call launched {launches}, want {want}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"moe: the loss did not descend: {losses}")

    plain_loss = float(make_eval_step(**TRAIN_LOSS)(state, batch))
    aux_loss = float(make_train_step(aux_loss_collection="losses", **TRAIN_LOSS)(state, batch)[1])
    ln_v = math.log(CONFIG_125M.vocab_size)
    log(f"[train] moe: a step with the aux losses: {aux_loss:.6f} (ln V {ln_v:.6f}; the same "
        f"weights without them {plain_loss:.6f})")
    if not aux_loss > ln_v or not aux_loss > plain_loss:
        raise AssertionError(f"moe aux step: {aux_loss} vs ln V {ln_v}, plain {plain_loss}")

    def timed(state, call):
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(state, stacked)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return sorted(secs)[1] / MOE_STEPS, secs

    rows = {}
    moe_s, moe_secs = timed(state, multi)
    params = {n: t for n, t in state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    dense = sharded_train_state(
        Transformer(dataclasses.replace(CONFIG_125M, attn_fn=flash.make_flash_attn_fn()),
                    device="cuda", seed=0), sgd(MOE_LR))
    multi(dense, stacked)                                   # warm-up
    dense_s, dense_secs = timed(dense, multi)
    del dense
    torch.cuda.empty_cache()
    for name, s, secs, cfg in (("moe", moe_s, moe_secs, _moe_cfg(moe_dispatch="scatter")),
                               ("dense", dense_s, dense_secs, CONFIG_125M)):
        flops = cfg.train_step_flops(MOE_B, TRAIN_S)
        rows[name] = dict(ms_per_step=s * 1e3, tok_s=MOE_B * TRAIN_S / s, mfu=mfu(flops, s),
                          flops_per_step=flops, call_seconds=secs)
    m, d = rows["moe"], rows["dense"]
    log(f"[time] 125M MoE (E=8, top-2, scatter) train step b={MOE_B} s={TRAIN_S}, sgd: "
        f"{m['ms_per_step']:.3f} ms/step, {m['tok_s']:.1f} tok/s, activated MFU {m['mfu']:.4f} "
        f"({m['flops_per_step'] / 1e12:.3f} TFLOP/step activated); the dense 125M step under "
        f"the same harness {d['ms_per_step']:.3f} ms/step, {d['tok_s']:.1f} tok/s, MFU "
        f"{d['mfu']:.4f} (medians of 3 {MOE_STEPS}-step calls) on {card}")
    return dict(layer_check=layer_errs, step_check=dict(loss_scatter=ls, loss_einsum=le,
                rel_loss_diff=diff, worst_grad_rel_err=rel[worst], worst_grad=worst),
                launches=launches, losses=losses, aux_step_loss=aux_loss,
                no_aux_loss=plain_loss, time=rows), params


def run_moe_generate_path(params, gen, card):
    """``[generate] moe``: greedy bf16 generation of the 125M MoE model
    (b=8, 128 + 32) through ``make_generate_fn``: decode attention once a
    layer a model call (the prefill's on the tensor cores, every token
    step split), a teacher-forced gap within ``TF_GAP``; tok/s and ms a
    token step. Then the same weights served at capacity E / top_k, where
    no token drops, also within ``TF_GAP``: at the model's 1.25 a token
    step's 8 tokens get 3 slots an expert, so a token's output hangs on its
    batchmates' routing, which the teacher-forced forward over the whole
    sequence does not share."""
    e, k = MOE_FIELDS["num_experts"], MOE_FIELDS["moe_top_k"]
    cfg = _moe_cfg(moe_dispatch="scatter", attn_fn=None)
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda",
                           dtype=torch.int32)
    fn = make_generate_fn(cfg, max_new_tokens=MOE_GEN_NEW, inference_dtype=torch.bfloat16)
    fn(params, prompt)                                      # warm-up
    torch.cuda.synchronize()
    reset_launches()
    out = fn(params, prompt)
    torch.cuda.synchronize()
    got = {k_: v for k_, v in read_launches().items() if k_.startswith("decode_attention")
           and k_ != "decode_attention_paged"}
    want = dict(generate_decode_launches(cfg, b=B, prompt=PROMPT, new=MOE_GEN_NEW),
                decode_attention=cfg.num_layers * MOE_GEN_NEW)
    log(f"[generate] moe: decode attention {got} (want {want})")
    if got != want:
        raise AssertionError(f"moe generate: decode attention launches {got}, want {want}")
    check_output(out, B, PROMPT + MOE_GEN_NEW, cfg.vocab_size)
    tf_model = Transformer(dataclasses.replace(cfg, param_dtype=torch.bfloat16), device="cuda",
                           seed=1).eval()
    tf_model.load_state_dict(params)
    span = ([PROMPT] * B, [PROMPT + MOE_GEN_NEW] * B)
    gaps = {cfg.moe_capacity_factor: teacher_forced_gap(tf_model, out, *span)}
    no_drop = dataclasses.replace(cfg, moe_capacity_factor=e / k)
    out_e_k = make_generate_fn(no_drop, max_new_tokens=MOE_GEN_NEW,
                               inference_dtype=torch.bfloat16)(params, prompt)
    for block in tf_model.blocks:
        block.moe.capacity_factor = no_drop.moe_capacity_factor
    gaps[no_drop.moe_capacity_factor] = teacher_forced_gap(tf_model, out_e_k, *span)
    del tf_model
    log(f"[generate] moe teacher-forced max gap by capacity factor "
        f"{ {c: round(g, 4) for c, g in gaps.items()} } (limit {TF_GAP})")
    if max(gaps.values()) > TF_GAP:
        raise AssertionError(f"moe generate teacher-forced gaps {gaps} > {TF_GAP}")
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(params, prompt)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    sec = sorted(secs)[1]
    row = dict(launches=got, gap=gaps[cfg.moe_capacity_factor],
               gap_capacity_e_over_k=gaps[no_drop.moe_capacity_factor],
               tok_s=B * MOE_GEN_NEW / sec, ms_per_step=sec / MOE_GEN_NEW * 1e3, seconds=secs)
    log(f"[time] 125M MoE generate b={B} prompt {PROMPT} +{MOE_GEN_NEW} bf16: "
        f"{row['tok_s']:.1f} tok/s, {row['ms_per_step']:.3f} ms/token-step (median of 3: "
        f"{[round(s, 4) for s in secs]}) on {card}")
    return row


def _a2a_rank(mesh, x, seed):
    """A rank of ``[mesh] moe a2a``: the all-to-all dispatch's output and
    gradients (whole) at the 125M MoE layer's widths."""
    from learning_jax_sharding_tpu_torch.ops.moe_dispatch import make_moe_a2a_fn
    from learning_jax_sharding_tpu_torch.parallel import logical

    rules = logical.RULES_DP_EP_A2A
    layer = _moe_layer("alltoall", seed, dispatch_fn=make_moe_a2a_fn(mesh, rules))
    with logical.activate(mesh, rules):
        out = layer(x).full_tensor()
        torch.sin(out).sum().backward()
    grads = {n: p.grad.full_tensor() if hasattr(p.grad, "full_tensor") else p.grad
             for n, p in layer.named_parameters()}
    return out.detach(), grads


def run_moe_a2a_path(gen, card):
    """``[mesh] moe a2a``: ``moe_a2a_ff`` (one all-to-all each way over
    ``data``) on a (2, 1) mesh of thread ranks at the 125M MoE layer's
    widths (fp32, b=4, s=1024), against the einsum dispatch run per token
    group on one rank: outputs and gradients within
    TestAllToAllDispatch's bounds."""
    from learning_jax_sharding_tpu_torch.parallel import run_on_threads

    x = torch.randn(MOE_B, TRAIN_S, CONFIG_125M.features, generator=gen, device="cuda")
    t0 = time.perf_counter()
    out, grads = run_on_threads(_a2a_rank, MOE_A2A_SHAPE, ("data", "model"), device_type="cuda",
                                args=(x, 1))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ref_layer = _moe_layer("einsum", 1)
    groups = MOE_A2A_SHAPE[0]
    ref = torch.cat([ref_layer(xg) for xg in x.chunk(groups)])
    torch.sin(ref).sum().backward()
    errs = dict(out=_within("a2a out", out, ref.detach(), *MOE_A2A_TOL["out"]))
    errs["grad"] = max(_within(f"a2a grad {n}", grads[n], p.grad, *MOE_A2A_TOL["grad"])
                       for n, p in ref_layer.named_parameters())
    log(f"[mesh] moe a2a: moe_a2a_ff on {MOE_A2A_SHAPE} thread ranks vs the grouped einsum "
        f"({groups} groups of {MOE_B * TRAIN_S // groups} tokens, {CONFIG_125M.features} -> "
        f"{CONFIG_125M.hidden}, E=8, top-2, fp32):"
        f" max abs err out {errs['out']:.2e}, grads {errs['grad']:.2e} (bounds "
        f"{MOE_A2A_TOL}); {secs:.2f} s forward + backward on {card}")
    return dict(errors=errs, seconds=secs)


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
                          r"|fused_norm_(?:warp_row_)?(?:fwd|bwd|reduce)"
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
    int4_decode = time_int4_decode(q4, q_prompt, card)
    quant_breakdown = int4_decode["int4-fused"]["profile"]
    del fused_fn, int4_fns
    torch.cuda.empty_cache()
    mark("int4 generate paths")
    engine = run_engine_path(params, q4, card)
    engine_ref_outs = engine.pop("ref_outs")
    mark("engine")
    modes = run_engine_modes(params, gen, card)
    torch.cuda.empty_cache()
    mark("[engine] modes")
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
    fit_path = run_fit_path(gen, card, train["ms_per_step"])
    torch.cuda.empty_cache()
    mark("[train] fit")
    remat_path = run_remat_path(gen, card)
    torch.cuda.empty_cache()
    mark("[train] remat")
    beam_path = run_beam_path(gen, card)
    torch.cuda.empty_cache()
    mark("[beam]")
    opt_batch = train_batch(gen, CONFIG_125M.vocab_size)
    precision_path = run_precision_path(gen, card, opt_batch)
    mark("[train] precision")
    zero1_path = run_zero1_path(card, opt_batch, precision_path)
    torch.cuda.empty_cache()
    mark("[train] zero1")
    lora_path = run_lora_path(gen, card, opt_batch)
    mark("[train] lora")
    seq_parallel = run_seq_parallel_path(gen, card)
    torch.cuda.empty_cache()
    mark("[train] sequence parallel")
    moe_train, moe_params = run_moe_train_path(gen, card)
    torch.cuda.empty_cache()
    mark("[train] moe")
    moe_generate = run_moe_generate_path(moe_params, gen, card)
    del moe_params
    torch.cuda.empty_cache()
    mark("[generate] moe")
    moe_a2a = run_moe_a2a_path(gen, card)
    torch.cuda.empty_cache()
    mark("[mesh] moe a2a")
    mesh_1x1 = run_mesh_1x1(gen, card)
    torch.cuda.empty_cache()
    mark("[mesh] 1x1")
    mesh_threads = run_mesh_threads(card)
    torch.cuda.empty_cache()
    mark("[mesh] 2x2 on one card")
    engine_mesh = run_engine_mesh(gen, card)
    torch.cuda.empty_cache()
    mark("[engine] mesh")
    engine_policies = run_engine_policies(engine_ref_outs, card)
    torch.cuda.empty_cache()
    mark("[engine] policies")
    engine_handoff = run_engine_handoff(engine_ref_outs, card)
    torch.cuda.empty_cache()
    mark("[engine] handoff")
    mesh_shards = run_mesh_shards(gen, card)
    torch.cuda.empty_cache()
    mark("[mesh] shards")
    flash_times, sdpa_times = time_flash(gen, card)
    norm_times = time_fused_norm(gen, card)
    torch.cuda.empty_cache()
    mark("flash and fused-norm kernel times")

    probe_errs = check_probes(gen)
    errs_1p4b = check_1p4b_kernels(gen)
    probe_paths = run_probe_paths(card)
    probe_times = time_probes(probe_paths, card)
    mark("probes")
    fused_1p4b = run_fused_generate_1p4b(card)
    mark("1.4B fused-norm generate")
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
        # The engine's decoding modes: the verify chunk's shape (checked,
        # its design, split and kernel, timed beside the token step), and
        # each mode's launches in its counted serve by shape and design.
        engine_modes=dict(verify=modes["verify"], launches={
            name: dict(total=r["decode_attention"], paged=r["decode_attention_paged"],
                       by_shape_and_design=r["designs"]) for name, r in modes["runs"].items()}),
        # The engine over a mesh: the shard shapes its (2, 2) ranks launch,
        # each timed in its public design and split.
        mesh_shard_shapes=engine_mesh["shard_shapes"],
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
            # [train] fit's uninterrupted run (12 steps): every launch on the
            # tensor cores.
            fit_launches=fit_path["launches"][name],
            fit_tensor_core_launches=fit_path["launches"][f"{name}_tensor_core"],
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
    # no-statistics forwards of the 125M and 1.4B fused-norm generates),
    # errors over every checked shape and design, top-level times at the
    # train rows (forward with the residual; backward without dr) in the
    # public design with the first design's beside them, every timed shape
    # under "shapes".
    train_rows = NORM_ROWS["train"]
    for name, key in (("fwd", f"fwd +resid {train_rows}x768 stats"),
                      ("bwd", f"bwd {train_rows}x768")):
        row = norm_times[key]
        errs = {design: norm_errs[name, torch.bfloat16, design] for design in NORM_DESIGNS}
        entries.append(dict(
            name=f"fused_norm_{name}", route="cuda", source=NORM_SOURCE,
            replaces=NORM_REPLACES[name], launches=fused_train["launches"][name],
            fit_launches=fit_path["norm_launches"][name],
            generate_launches=fused_gen["launches"]["fwd_nostats" if name == "fwd" else name],
            generate_1p4b_launches=fused_1p4b["launches"]["fwd_nostats" if name == "fwd"
                                                          else name],
            max_abs_err=errs["row_group"][1], max_err_bf16=errs["row_group"][0],
            max_err_fp32=norm_errs[name, torch.float32, "row_group"][0],
            bf16_differing_share=errs["row_group"][2],
            **{k: row[k] for k in timing_keys},
            library_call="torch.nn.functional.layer_norm(x + resid)" if name == "fwd" else
            "autograd backward of torch.nn.functional.layer_norm",
            design="row_group (ops/fused_norm.py::_design; the backward in one launch, its "
                   "column sums through a cluster and the last cluster to finish)",
            warp_row_ms=row["warp_row_ms"], warp_row_max_err_bf16=errs["warp_row"][0],
            widths=sorted(NORM_WIDTHS),
            instantiations=sorted(k for k, _, _ in ptxas_usage(
                _build.reports.get("fused_norm", "")) if k.startswith(f"fused_norm_{name}")),
            shapes={k: v for k, v in norm_times.items() if k.startswith(name)},
            geometry_ms=norm_times["geometry"][name],
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
    # The mesh paths' launches of each kernel: the one-rank mesh's train call
    # and generates (equal to the unsharded runs'), the four thread ranks'
    # train call and generates in all, and a shard's launch in the
    # per-shard phase with the design it took.
    mesh_runs = {"1x1 train (8-step call)": mesh_1x1["train"]["launches"],
                 **{f"1x1 generate {k}": v["launches"]
                    for k, v in mesh_1x1["generate"].items()},
                 "2x2 train + generates (4 ranks)": mesh_threads["launches"],
                 "engine 1x1 split": engine_mesh["one_rank"]["launches"],
                 **{f"engine 2x2 {k} (4 ranks)": v["launches"]
                    for k, v in engine_mesh["threads"].items()}}
    for entry in entries:
        keys = {"fused_norm_fwd": ("fused_norm_fwd", "fused_norm_fwd_nostats")}.get(
            entry["name"], (entry["name"],))
        counts = {run: sum(c.get(k, 0) for k in keys) for run, c in mesh_runs.items()}
        entry["mesh_launches"] = {run: n for run, n in counts.items() if n}
        per_shard = {layout: shard_rows(entry["name"], rows)
                     for layout, rows in mesh_shards.items()}
        entry["mesh_per_shard"] = per_shard if any(per_shard.values()) else None
        # The [engine] policies phase's counted serve (telemetry attached).
        n = engine_policies["telemetry"]["launches"].get(entry["name"], 0)
        entry["policies_launches"] = n or None
        # The [engine] handoff phase's counted runs: the disaggregated serve,
        # the tier's cold and warm serves and the swaps' steps.
        entry["handoff_launches"] = (engine_handoff["launches"]
                                     if entry["name"] == "decode_attention" else None)
        # [beam]'s counted searches; [train] remat's one step of each variant.
        entry["beam_launches"] = ({k: v["decode_attention"] for k, v in
                                   beam_path["launches"].items()}
                                  if entry["name"] == "decode_attention" else None)
        kind, _, key = entry["name"].partition("_")
        if entry["name"].startswith("fused_norm_"):
            kind, key = "fused_norm", entry["name"][len("fused_norm_"):]
        entry["remat_launches"] = ({variant: row["launches"][kind][key]
                                    for variant, row in remat_path.items()}
                                   if kind in ("flash", "fused_norm") else None)
        # [train] precision / zero1 / lora: each phase's counted call, and
        # decode attention in the EMA and merged-LoRA generates.
        # Slice 22: each strategy's counted and timed steps on four thread
        # ranks (Ulysses' flash on each rank's (1, 8192, 3, 128) heads; the
        # ring runs no flash), the MoE train call, the MoE generate.
        entry["seq_parallel_launches"] = ({
            s: seq_parallel[s]["launches"].get(entry["name"], 0) for s in ("ring", "ulysses")}
            if kind == "flash" else None)
        entry["moe_launches"] = ({"train (2-step call)": moe_train["launches"][entry["name"]]}
                                 if kind == "flash" else
                                 {"generate": moe_generate["launches"]["decode_attention"]}
                                 if entry["name"] == "decode_attention" else None)
        entry["optimizer_launches"] = ({
            "precision (8 steps)": precision_path["launches"].get(entry["name"], 0),
            "zero1 (2 ranks x 8 steps)": zero1_path["launches"].get(entry["name"], 0),
            "lora (1 step)": lora_path["launches"].get(entry["name"], 0)}
            if kind in ("flash", "fused_norm") else
            {"precision EMA generate": precision_path["ema_generate_launches"],
             "lora merged generate": lora_path["generate_launches"]}
            if entry["name"] == "decode_attention" else None)
    generate = dict(tok_s=main_path["tok_s"], ms_per_token_step=main_path["ms_per_step"],
                    teacher_forced_max_gap=main_path["gap"], step_breakdown=breakdown)
    quantized = dict(runs=quant, ladder=ladder, int4_fused_step_breakdown=quant_breakdown,
                     int4_prefill=int4_prefill,
                     int4_decode={k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                                  | {"busy_ms_per_step": v["profile"]["busy_ms_per_step"]}
                                  for k, v in int4_decode.items()})
    print(json.dumps({"kernels": entries, "generate": generate, "quantized": quantized,
                      "train": train, "train_step_check": step, "sdpa": sdpa_times,
                      "fit": fit_path, "train_remat": remat_path, "beam": beam_path,
                      "train_precision": precision_path, "train_zero1": zero1_path,
                      "train_lora": lora_path, "train_seq_parallel": seq_parallel,
                      "train_moe": moe_train, "generate_moe": moe_generate,
                      "mesh_moe_a2a": moe_a2a,
                      "fused_norm_train": fused_train, "fused_norm_generate": fused_gen,
                      "fused_norm_generate_1p4b": fused_1p4b,
                      "int8_cache_generate": int8_gen, "engine": engine,
                      "engine_modes": modes,
                      "launch_audit": probe_paths["audit"],
                      "flash_ceiling": probe_paths["flash_ceiling"],
                      "designs_1p4b": designs_1p4b, "checks_1p4b": errs_1p4b,
                      "mesh_1x1": mesh_1x1, "mesh_threads": mesh_threads,
                      "engine_mesh": engine_mesh, "engine_policies": engine_policies,
                      "engine_handoff": engine_handoff,
                      "mesh_shards": mesh_shards}, default=str))
    print(card)
    print(json.dumps(result_line(torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
