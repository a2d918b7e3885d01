"""Case 13: a HuggingFace GPT-2 served by the port, and exported back.

Port of ``cases/case13_hf_interop.py``. Builds a randomly initialised
``transformers.GPT2LMHeadModel`` (no download: parity, not pretraining, is
the point) and walks the interop chain on the port:

  GPT2LMHeadModel → params_from_hf_gpt2                 (import)
  → logits parity with the torch model on the same tokens (proof)
  → KV-cached greedy generation on a (2, 2) data × model mesh of thread
    ranks under RULES_DP_TP                              (serve)
  → int8 weight-only quantization, served dequantized   (compress)
  → state_dict_from_params → a fresh HF model → parity  (export round trip)

It imports ``transformers``, which the machine with the card lacks, so
``chip_smoke.py`` does not run it; the card is the default all the same,
and ``--cpu`` (``main(device_type="cpu")``) runs it on the CPU:

    python -m learning_jax_sharding_tpu_torch.cases.case13_hf_interop [--cpu]
"""

import sys

import numpy as np
import torch

from learning_jax_sharding_tpu_torch.cases import say
from learning_jax_sharding_tpu_torch.models.convert import (
    config_from_hf_gpt2,
    params_from_hf_gpt2,
    state_dict_from_params,
)
from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn
from learning_jax_sharding_tpu_torch.models.quantize import quantize_tree, quantized_bytes
from learning_jax_sharding_tpu_torch.models.transformer import Transformer
from learning_jax_sharding_tpu_torch.parallel import run_on_threads
from learning_jax_sharding_tpu_torch.parallel.logical import RULES_DP_TP

NEW = 16
LOGIT_ATOL = 5e-3       # the JAX case's bound: torch and the port sum in other orders
EXPORT_ATOL = 1e-5


def serve(mesh, cfg, sd, q8, prompt):
    """Rank body: greedy generation of the converted weights over the
    mesh, in fp32 and int8-dequantized bf16."""
    device = mesh.device_type
    gen = make_generate_fn(cfg, mesh, RULES_DP_TP, max_new_tokens=NEW, device=device)
    out = gen(sd, prompt.to(device)).cpu().numpy()
    gen_q = make_generate_fn(cfg, mesh, RULES_DP_TP, max_new_tokens=NEW, device=device,
                             inference_dtype=torch.bfloat16, dequantize=True)
    return out, gen_q(q8, prompt.to(device)).cpu().numpy()


def main(device_type: str = "cuda"):
    from transformers import GPT2Config, GPT2LMHeadModel

    if device_type == "cpu":
        torch.set_num_threads(1)
    torch.manual_seed(0)
    # head_dim 64: the card's decode attention kernel takes 64 or 128.
    hf = GPT2LMHeadModel(GPT2Config(
        n_layer=2, n_embd=256, n_head=4, vocab_size=256, n_positions=128,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    )).eval()

    # Import.
    cfg = config_from_hf_gpt2(hf.config)
    sd = params_from_hf_gpt2(hf)
    say(f"imported GPT-2: {cfg.num_layers} layers, {cfg.features} wide, "
        f"use_bias={cfg.use_bias}, eps={cfg.norm_eps}")

    # Proof: the torch model's logits.
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        want = hf(tok).logits.numpy()
        model = Transformer(cfg, device=device_type)
        model.load_state_dict(sd)
        got = model(tok.to(device_type)).float().cpu().numpy()
    diff = float(np.abs(want - got).max())
    say(f"logit parity vs torch: max diff {diff:.2e}")
    assert diff < LOGIT_ATOL and (want.argmax(-1) == got.argmax(-1)).all()

    # Serve through the port's stack: greedy decode over a mesh, then int8.
    q8 = quantize_tree(sd)
    prompt = tok[:, :8].to(torch.int32)
    out, out_q = run_on_threads(serve, (2, 2), ("data", "model"), device_type=device_type,
                                args=(cfg, sd, q8, prompt))
    assert out.shape == (2, 8 + NEW) and (out[:, :8] == prompt.numpy()).all()
    say(f"sharded generation: {out.shape}, continuation {out[0, 8:14].tolist()}")
    agree = float((out_q[:, 8] == out[:, 8]).mean())
    say(f"int8-served first tokens agree on {agree:.0%} of rows; weight bytes "
        f"{quantized_bytes(sd) / 1e6:.1f} → {quantized_bytes(q8) / 1e6:.1f} MB")

    # Export round trip: a fresh HF model on the exported state dict.
    hf2 = GPT2LMHeadModel(hf.config).eval()
    hf2.load_state_dict(state_dict_from_params(sd), strict=False)
    hf2.tie_weights()
    with torch.no_grad():
        back = hf2(tok).logits.numpy()
    round_trip = float(np.abs(back - want).max())
    say(f"export round-trip parity: max diff {round_trip:.2e}")
    assert round_trip < EXPORT_ATOL
    say("PASS: HF checkpoint → port serve (sharded, int8) → HF export")
    return dict(logit_diff=diff, tokens=out, int8_tokens=out_q, int8_agree=agree,
                round_trip_diff=round_trip)


if __name__ == "__main__":
    main(device_type="cpu" if "--cpu" in sys.argv[1:] else "cuda")
