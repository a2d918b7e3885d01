"""Per-launch accounting of the decode gap at a 1.4B shape.

Port of ``scripts/perf_launch_audit.py``. The port's decode is host-bound:
a token step costs several times its device work. This audit asks whether
the launch chain explains the gap, from one process:

1. COUNT: one token step (``advance``: one cached S=1 model call and the
   greedy pick) under ``torch.profiler``, per variant: its device kernels,
   split into the port's own (``PORT_KERNELS``) and all others.
2. COST: the launch floors of ``perf_call_floor`` in the same process, per
   launch: eager (host clock) and graph (device side), the copy probe's for
   the port's kernels (a ctypes wrapper of the port) and one eager
   elementwise op's for all others (PyTorch's own launch path), as the JAX
   audit priced custom calls at the Pallas no-op and fusions at the tiny
   XLA kernel.
3. GAP: each variant's measured ms per token of ``make_generate_fn`` less
   its byte roofline (served weights plus the mean valid KV cache at the
   port's bf16 cache, over the card's peak memory rate).

If count × eager floor ≈ gap, the launch chain explains the gap (and a
CUDA graph of the step would close most of it); if it falls well short,
the time goes elsewhere.

The variants, at b=8, prompt 64, +64 greedy, bf16 compute, seeded random
weights: bf16; ``quantize_tree(bits=8)`` dequantized in every call
(``dequantize=True``); ``quantize_tree(bits=4)`` through the fused kernels
(``dequantize="fused"``).

    python -m learning_jax_sharding_tpu_torch.scripts.perf_launch_audit
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from learning_jax_sharding_tpu_torch.models.decoding import (
    apply_dequantize_policy,
    derive_decode_config,
    make_cached_apply,
    make_param_caster,
)
from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn
from learning_jax_sharding_tpu_torch.models.quantize import (
    map_unquantized,
    quantize_tree,
    quantized_bytes,
)
from learning_jax_sharding_tpu_torch.models.transformer import Transformer, TransformerConfig
from learning_jax_sharding_tpu_torch.scripts.perf_call_floor import copy_floor
from learning_jax_sharding_tpu_torch.utils.bench import device_peak_hbm_bw, device_profile

#: The JAX script's 1.4B decode shape (``scripts/perf_launch_audit.py:55-58``).
CONFIG_1P4B = TransformerConfig(num_layers=24, features=2048, num_heads=16, head_dim=128,
                                hidden=8192, max_seq_len=256)
B, PROMPT, NEW = 8, 64, 64
PROFILED_STEPS = 4
ROUNDS = 3


def to_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16) if t.is_floating_point() else t


def variants(params: dict) -> list[tuple[str, dict, bool | str]]:
    """``(label, state dict, dequantize)`` of the three variants."""
    return [("bf16", {k: to_bf16(v) for k, v in params.items()}, False),
            ("int8 dequant", quantize_tree(params), True),
            ("int4 fused", quantize_tree(params, bits=4), "fused")]


def cache_bytes(cfg: TransformerConfig, b: int, prompt: int, new: int, itemsize: int = 2) -> float:
    """The mean valid K and V a token step reads over ``new`` steps."""
    n_kv = cfg.num_kv_heads or cfg.num_heads
    return cfg.num_layers * b * n_kv * (prompt + new / 2) * cfg.head_dim * 2 * itemsize


def roofline_ms(cfg, tree, b, prompt, new) -> tuple[float, float]:
    """(ms a token step at the card's peak memory rate, served bytes): the
    weights as served (floats in bf16, quantized nodes as they are) and the
    mean valid bf16 KV cache."""
    served = quantized_bytes(map_unquantized(to_bf16, tree))
    return (served + cache_bytes(cfg, b, prompt, new)) / device_peak_hbm_bw() * 1e3, served


def token_step(cfg, tree, dequantize, prompt, device="cuda"):
    """``advance()``: one greedy token step of ``make_generate_fn``'s loop
    (one cached S=1 model call, then the argmax pick) on a cache the prompt
    filled, built as ``make_generate_fn`` builds its model. ``advance.state``
    holds the last picked tokens (``"tok"``) and the cache."""
    dcfg, fused = apply_dequantize_policy(derive_decode_config(cfg, torch.bfloat16), dequantize)
    model = Transformer(dcfg, device=device).eval()
    weights = make_param_caster(torch.bfloat16, device, dequantize=bool(dequantize))(tree)
    in_apply = bool(dequantize) and not fused
    if not in_apply:
        model.load_state_dict(weights)
        weights = None
    apply = make_cached_apply(model, dequantize=in_apply, dequant_dtype=dcfg.param_dtype)
    with torch.no_grad():
        logits, cache = apply(None, prompt, params=weights)
    state = {"tok": logits[:, -1].argmax(-1).to(torch.int32), "cache": cache}

    @torch.no_grad()
    def advance():
        logits, state["cache"] = apply(state["cache"], state["tok"][:, None], params=weights)
        state["tok"] = logits[:, -1].argmax(-1).to(torch.int32)

    advance.state = state
    return advance


def count_step_kernels(advance, steps: int = PROFILED_STEPS) -> dict:
    """Device kernels a token step, from ``steps`` steps under the
    profiler: all of them, the port's own and the others, the port's by
    name, and the device-busy ms a step (what a replay of the step with no
    host time between its kernels would come down to)."""
    advance()
    torch.cuda.synchronize()

    def run():
        for _ in range(steps):
            advance()

    prof = device_profile(run, steps)
    return dict(kernels=prof["kernels"], port=prof["port"], other=prof["kernels"] - prof["port"],
                port_by_name=prof["port_by_name"], busy_ms=prof["busy_ms"])


def decode_ms(fn, tree, prompt, new, rounds: int = ROUNDS) -> tuple[float, list[float]]:
    """ms per token of ``fn(tree, prompt)`` (a ``make_generate_fn``
    generate of ``new`` tokens, prefill included, as the JAX audit divides
    it): host clock around synchronised calls after a warm-up, the median
    of ``rounds``."""
    fn(tree, prompt)
    secs = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(tree, prompt)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs) / new * 1e3, secs


def audit(cfg: TransformerConfig = CONFIG_1P4B, b: int = B, prompt_len: int = PROMPT,
          new: int = NEW, seed: int = 0, floors: dict | None = None, check=None,
          log=print) -> dict:
    """The audit: per variant COUNT, COST and GAP (the module's three
    steps). ``floors``: ``perf_call_floor.copy_floor()``'s rows (measured
    here when None). ``check(label, generate, tree, prompt)``, when given,
    runs once per variant after its timing (the chip smoke counts the
    launches of one generate there)."""
    floors = floors or copy_floor()
    port, other = floors["copy_probe"], floors["elementwise"]
    log(f"[audit] launch floors a launch: the port's (copy probe) eager "
        f"{port['eager_ms'] * 1e3:.2f} us, graph {port['graph_ms'] * 1e3:.2f} us; PyTorch's "
        f"(one elementwise op) eager {other['eager_ms'] * 1e3:.2f} us, graph "
        f"{other['graph_ms'] * 1e3:.2f} us")
    params = Transformer(cfg, device="cuda", seed=seed).state_dict()
    log(f"[audit] params ~{cfg.param_count / 1e9:.2f}B")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (b, prompt_len), generator=gen, device="cuda",
                           dtype=torch.int32)
    trees = variants(params)
    del params
    gc.collect()
    rows = {}
    for label, tree, deq in trees:
        counts = count_step_kernels(token_step(cfg, tree, deq, prompt))
        fn = make_generate_fn(cfg, max_new_tokens=new, inference_dtype=torch.bfloat16,
                              dequantize=deq)
        ms, secs = decode_ms(fn, tree, prompt, new)
        roof, served = roofline_ms(cfg, tree, b, prompt_len, new)
        row = dict(counts, ms_per_token=ms, seconds=secs, tok_s=b * new / statistics.median(secs),
                   roofline_ms=roof, served_mb=served / 1e6, gap_ms=ms - roof,
                   eager_floor_ms=counts["port"] * port["eager_ms"]
                   + counts["other"] * other["eager_ms"],
                   graph_floor_ms=counts["port"] * port["graph_ms"]
                   + counts["other"] * other["graph_ms"])
        rows[label] = row
        log(f"[audit] {label}: {ms:.3f} ms/token measured ({row['tok_s']:,.1f} tok/s), byte "
            f"roofline {roof:.3f} ms (served {served / 1e6:,.1f} MB), gap {ms - roof:.3f} ms; "
            f"{row['kernels']:.1f} kernels a token step ({row['port']:.1f} the port's, "
            f"{row['other']:.1f} others), device busy {row['busy_ms']:.3f} ms a step -> count x "
            f"eager floor {row['eager_floor_ms']:.3f} ms, x graph floor "
            f"{row['graph_floor_ms']:.3f} ms; the port's: {row['port_by_name']}")
        if check is not None:
            check(label, fn, tree, prompt)
        del fn
        gc.collect()
        torch.cuda.empty_cache()
    log("[audit] | variant | kernels/step | port | other | measured ms | roofline ms | gap ms "
        "| count x eager floor ms | count x graph floor ms | device busy ms |")
    for label, r in rows.items():
        log(f"[audit] | {label} | {r['kernels']:.1f} | {r['port']:.1f} | {r['other']:.1f} | "
            f"{r['ms_per_token']:.3f} | {r['roofline_ms']:.3f} | {r['gap_ms']:.3f} | "
            f"{r['eager_floor_ms']:.3f} | {r['graph_floor_ms']:.3f} | {r['busy_ms']:.3f} |")
    return dict(floors=floors, variants=rows)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("perf_launch_audit measures the card: no CUDA device")
    print(f"[audit] {torch.cuda.get_device_name(0)}", flush=True)
    audit(log=lambda msg: print(msg, flush=True))


if __name__ == "__main__":
    main()
