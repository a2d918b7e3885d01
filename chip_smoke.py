#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``learning_jax_sharding_tpu_torch/csrc``
(into ``build/torch_kernels/``), holds it against its plain PyTorch version
on the card, then drives the port's main path, KV-cached greedy generation of
the 125M model (seeded random weights, bf16) through ``make_generate_fn``,
and checks the result against a teacher-forced dense forward. Every phase
raises on failure; the last line is the JSON ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_125M, Transformer
from learning_jax_sharding_tpu_torch.ops import _build
from learning_jax_sharding_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
)
from learning_jax_sharding_tpu_torch.utils.bench import (
    device_peak_flops,
    device_peak_hbm_bw,
    time_fn,
)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16: both sides accumulate in fp32, the output rounds to bf16 (2^-8
# relative at |out| ≲ 2).
B, PROMPT, NEW = 8, 128, 128
TF_GAP = 0.1   # teacher-forced: generated token's logit vs the position's max
KERNEL_SOURCE = "learning_jax_sharding_tpu_torch/csrc/decode_attention.cu"
REPLACES = "learning_jax_sharding_tpu/ops/decode_attention.py:83"


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


def kernel_case(name, gen, dtype, *, b, s, n, n_kv, h, length, index,
                window=None, fold=False, write_enable=None):
    """One kernel-vs-plain comparison on the card → max abs error."""
    q = randn(gen, b, s, n, h, dtype=dtype)
    kc = randn(gen, b, n_kv, length, h, dtype=dtype)
    vc = randn(gen, b, n_kv, length, h, dtype=dtype)
    kw = dict(window=window)
    if fold:
        kw.update(k_new=randn(gen, b, n_kv, 1, h, dtype=dtype),
                  v_new=randn(gen, b, n_kv, 1, h, dtype=dtype),
                  write_enable=write_enable)
    k0, v0 = kc.clone(), vc.clone()
    kr, vr = kc.clone(), vc.clone()
    out = decode_attention(q, kc, vc, index, **kw)
    ref = decode_attention_reference(q, kr, vr, index, **kw)
    torch.cuda.synchronize()
    if fold:
        out, ref = out[0], ref[0]
        if not (torch.equal(kc, kr) and torch.equal(vc, vr)):
            raise AssertionError(f"{name}: folded write differs from the plain version")
        idx = index.tolist()
        enabled = [True] * b if write_enable is None else [bool(e) for e in write_enable.tolist()]
        for row in range(b):
            if enabled[row]:
                for cache, new in ((kc, kw["k_new"]), (vc, kw["v_new"])):
                    if not torch.equal(cache[row, :, idx[row]], new[row, :, 0]):
                        raise AssertionError(f"{name}: row {row} slot not written")
            elif not (torch.equal(kc[row], k0[row]) and torch.equal(vc[row], v0[row])):
                raise AssertionError(f"{name}: disabled row {row} cache changed")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    log(f"[kernel] {name} {str(dtype)[6:]}: max abs err {err:.3e} (tol {TOL[dtype]:g})")
    if err > TOL[dtype]:
        raise AssertionError(f"{name} {dtype}: max abs err {err} > {TOL[dtype]}")
    return err


def check_kernel(gen):
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        mha = dict(b=B, n=12, n_kv=12, h=64, length=1024)
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
                        length=1024, index=zero + 300, window=64),
        ]
        errs[dtype] = max(cases)
    return errs


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


def profile_generate(params, gen, ms_per_step):
    """Where a token step's time goes: one rectangular generate call under
    torch.profiler → device kernels per step, device-busy time per step, and
    the idle share against the unprofiled ms/step."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompt = torch.randint(0, CONFIG_125M.vocab_size, (B, PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    rect = make_generate_fn(CONFIG_125M, max_new_tokens=NEW, inference_dtype=torch.bfloat16)
    rect(params, prompt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rect(params, prompt)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler saw no device kernels")
    busy_us, by_name = 0.0, Counter()
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        busy_us += dur
        by_name[e.name] += dur
    busy_ms = busy_us / 1e3 / NEW
    top = [(name[:60], round(us / 1e3 / NEW, 4)) for name, us in by_name.most_common(6)]
    row = dict(kernels_per_step=len(kernels) / NEW, busy_ms_per_step=busy_ms,
               idle_share=1 - busy_ms / ms_per_step, top_ms_per_step=top)
    log(f"[profile] per token step: {row['kernels_per_step']:.1f} device kernels, "
        f"device busy {busy_ms:.3f} ms of {ms_per_step:.3f} ms unprofiled "
        f"(idle share {row['idle_share']:.3f}); top: {top}")
    return row


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
    bw = device_peak_hbm_bw() or 3.35e12
    flops = device_peak_flops() or 989e12
    t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=library_ms, bytes=nbytes, ops=ops)
    log(f"[time] decode_attention {name} (q {tuple(q.shape)}, index {index}, bf16): "
        f"kernel {ms * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}), "
        f"plain {plain_ms * 1e3:.2f} us, sdpa {library_ms * 1e3:.2f} us")
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[preflight] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = _build.build("decode_attention")
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = check_kernel(gen)

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
    log(f"[time] measured on {card}")

    entry = dict(
        name="decode_attention", route="cuda", source=KERNEL_SOURCE, replaces=REPLACES,
        launches=main_path["rect_launches"], ragged_launches=main_path["ragged_launches"],
        max_abs_err=errs[torch.bfloat16],
        max_err_bf16=errs[torch.bfloat16], max_err_fp32=errs[torch.float32],
        **{k: decode[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        shapes={"prefill": prefill, "decode": decode},
    )
    print(json.dumps({"kernels": [entry], "tok_s": main_path["tok_s"],
                      "ms_per_token_step": main_path["ms_per_step"],
                      "teacher_forced_max_gap": main_path["gap"],
                      "step_breakdown": breakdown}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
