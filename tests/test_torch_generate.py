"""The port's generation against the JAX package's, token for token.

Same converted weights, same prompts, fp32, greedy: the port's
``make_generate_fn`` must emit exactly the tokens of the JAX
``make_generate_fn`` on a (1, 1) mesh, with the blocked backend (JAX: its
Pallas kernel in interpret mode; the port: the kernel's plain version on the
CPU) and with the dense one. The sampling filters are compared on fixed
logits. Also the no-JAX guard of the port package.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu.models import generate as jax_generate
from learning_jax_sharding_tpu.models.transformer import (
    CONFIG_TINY as JAX_TINY,
    Transformer as JaxTransformer,
)
from learning_jax_sharding_tpu.parallel import build_mesh
from learning_jax_sharding_tpu.parallel.logical import RULES_DP_TP
from learning_jax_sharding_tpu_torch.models import generate
from learning_jax_sharding_tpu_torch.models.convert import from_flax_params
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LENGTHS = [3, 8, 5, 1]
NEW = 6


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, JAX_TINY.vocab_size, size=(4, 8)).astype(np.int32)
    params = JaxTransformer(JAX_TINY).init(jax.random.key(0), jnp.asarray(prompt))["params"]
    params = jax.tree.map(np.asarray, nn.meta.unbox(params))
    mesh = build_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    return prompt, params, mesh


def _run_both(setup, backend, *, lengths=None, **kw):
    prompt, params, mesh = setup
    mods = dict(decode_attention=backend, decode_block_k=16)
    jgen = jax_generate.make_generate_fn(
        dataclasses.replace(JAX_TINY, **mods), mesh, RULES_DP_TP,
        max_new_tokens=NEW, **kw,
    )
    cfg = dataclasses.replace(CONFIG_TINY, **mods)
    tgen = generate.make_generate_fn(cfg, max_new_tokens=NEW, device="cpu", **kw)
    if lengths is None:
        ref = jgen(params, jnp.asarray(prompt))
        out = tgen(from_flax_params(params, cfg), prompt)
    else:
        ref = jgen(params, jnp.asarray(prompt), lengths=np.asarray(lengths))
        out = tgen(from_flax_params(params, cfg), prompt, lengths=lengths)
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize(
    "backend,mode",
    [
        ("blocked", "rectangular"),
        ("blocked", "prefill_chunk"),
        ("blocked", "repetition_penalty"),
        ("blocked", "ragged_eos"),
        ("dense", "rectangular"),
        ("dense", "ragged_eos"),
    ],
)
def test_greedy_tokens_match_jax(setup, backend, mode):
    kw = {
        "rectangular": {},
        "prefill_chunk": dict(prefill_chunk_size=3),
        "repetition_penalty": dict(repetition_penalty=1.5),
        "ragged_eos": dict(ragged=True),
    }[mode]
    if mode != "ragged_eos":
        ref, out = _run_both(setup, backend, **kw)
        np.testing.assert_array_equal(out, ref)
        return
    # EOS = row 0's second generated token, so the early exit really fires.
    plain_ref, plain_out = _run_both(setup, backend, lengths=LENGTHS, **kw)
    np.testing.assert_array_equal(plain_out, plain_ref)
    eos = int(plain_ref[0, LENGTHS[0] + 1])
    ref, out = _run_both(setup, backend, lengths=LENGTHS, eos_id=eos, **kw)
    np.testing.assert_array_equal(out, ref)
    assert (out[0, LENGTHS[0] + 2 :] == eos).all()


def test_sampling_at_top_k_1_is_greedy(setup):
    """Sampling through the filters with a single survivor is the argmax,
    whatever the generator draws; a seeded generator repeats itself."""
    prompt, params, _ = setup
    sd = from_flax_params(params, CONFIG_TINY)
    greedy = generate.make_generate_fn(CONFIG_TINY, max_new_tokens=NEW, device="cpu")
    sampled = generate.make_generate_fn(
        CONFIG_TINY, max_new_tokens=NEW, device="cpu", temperature=0.7, top_k=1
    )
    np.testing.assert_array_equal(sampled(sd, prompt).numpy(), greedy(sd, prompt).numpy())
    free = generate.make_generate_fn(
        CONFIG_TINY, max_new_tokens=NEW, device="cpu", temperature=1.0, top_p=0.9
    )
    a = free(sd, prompt, torch.Generator().manual_seed(5))
    b = free(sd, prompt, torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_filters_match_jax():
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(3, 64)).astype(np.float32) * 3
    seen = rng.random((3, 64)) < 0.2
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    pairs = [
        (jax_generate.top_k_filter(jl, 5), generate.top_k_filter(tl, 5)),
        (jax_generate.top_p_filter(jl, 0.8), generate.top_p_filter(tl, 0.8)),
        (jax_generate.min_p_filter(jl, 0.1), generate.min_p_filter(tl, 0.1)),
        (jax_generate.vocab_limit_filter(jl, 50), generate.vocab_limit_filter(tl, 50)),
        (
            jax_generate.repetition_penalty_filter(jl, jnp.asarray(seen), 1.3),
            generate.repetition_penalty_filter(tl, torch.from_numpy(seen), 1.3),
        ),
        (
            jax_generate.filtered_logits(jl, 0.7, 10, 0.9, 0.05, 60),
            generate.filtered_logits(tl, 0.7, 10, 0.9, 0.05, 60),
        ),
    ]
    for ref, out in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    greedy = generate._sample(tl, 0.0, None, vocab_limit=50)
    np.testing.assert_array_equal(
        greedy.numpy(), np.asarray(jax_generate._sample(jl, 0.0, None, vocab_limit=50))
    )


def test_generate_validation(setup):
    prompt, params, _ = setup
    sd = from_flax_params(params, CONFIG_TINY)
    with pytest.raises(ValueError, match="prefill_chunk_size"):
        generate.make_generate_fn(
            CONFIG_TINY, max_new_tokens=2, ragged=True, prefill_chunk_size=4, device="cpu"
        )
    gen = generate.make_generate_fn(CONFIG_TINY, max_new_tokens=2, ragged=True, device="cpu")
    with pytest.raises(ValueError, match="lengths"):
        gen(sd, prompt)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        generate.make_generate_fn(CONFIG_TINY, max_new_tokens=60, device="cpu")(sd, prompt)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate.make_generate_fn(CONFIG_TINY, max_new_tokens=2)


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "learning_jax_sharding_tpu")


def _port_sources():
    return sorted((REPO / "learning_jax_sharding_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"
    ]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_import_leaves_jax_out_and_builds_nothing():
    code = (
        "import sys\n"
        "import learning_jax_sharding_tpu_torch.models.generate\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'learning_jax_sharding_tpu' not in sys.modules\n"
        "from learning_jax_sharding_tpu_torch.ops import _build\n"
        "assert not _build._loaded, 'a kernel was built at import'\n"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
