"""The host time a one-rank mesh adds to the 125M continuous engine, a
model call, for two trees of the port on one card.

``chip_smoke.py``'s ``[engine] mesh 1x1`` line, alone: the 125M engine
(bf16, blocked decode attention, seeded random weights) serves the first 8
requests of the engine queue (a shared 512-token system prompt plus 32
tokens each, numpy seed 0, +32 tokens) once over a one-rank cuda mesh under
``RULES_DP_TP`` and once without a mesh; after a warm-up serve of each, the
two serves are timed interleaved (``ROUNDS`` rounds, every other one in
reverse order) and the medians are divided by the serve's model calls.

``--tree DIR`` times the port found under ``DIR`` (one process a tree, so
two versions of the package never share an interpreter) and prints one
JSON line. ``--compare PARENT`` runs ``--tree PARENT``, ``--tree .``,
``--tree .``, ``--tree PARENT`` in turn and prints each run's line, then a
summary of the medians by tree::

    python -m learning_jax_sharding_tpu_torch.scripts.perf_engine_mesh_host \\
        --compare build/parent
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROUNDS = 5
REQUESTS, SYSTEM, OWN, NEW = 8, 512, 32, 32
ENGINE = dict(batch_size=8, max_new_tokens=NEW, refill_chunk=64, decode_block_steps=NEW,
              decode_chain=9)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def time_tree(tree: str) -> dict:
    """One tree's serves, timed (the port imported from ``tree``)."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import dataclasses

    import torch

    import learning_jax_sharding_tpu_torch as port
    from learning_jax_sharding_tpu_torch.models.serving import make_continuous_engine
    from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_125M, Transformer
    from learning_jax_sharding_tpu_torch.parallel import logical, single_device_mesh

    rng = np.random.default_rng(0)
    system = rng.integers(1, CONFIG_125M.vocab_size, size=(SYSTEM,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(1, CONFIG_125M.vocab_size, size=(OWN,))
                               .astype(np.int32)]) for _ in range(REQUESTS)]
    cfg = dataclasses.replace(CONFIG_125M, decode_attention="blocked")
    params = Transformer(CONFIG_125M, device="cuda", seed=0).state_dict()
    kw = dict(ENGINE, inference_dtype=torch.bfloat16)
    serves = {"mesh": make_continuous_engine(cfg, single_device_mesh(device_type="cuda"),
                                             logical.RULES_DP_TP, **kw),
              "one": make_continuous_engine(cfg, **kw)}
    calls, toks = {}, {}
    for name, serve in serves.items():
        forwards = serve.engine.model_forwards
        toks[name] = serve(params, prompts)
        calls[name] = serve.engine.model_forwards - forwards
    times = {name: [] for name in serves}
    for r in range(ROUNDS):
        for name, serve in (list(serves.items())[::-1] if r % 2 else serves.items()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve(params, prompts)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    ms = {name: statistics.median(t) * 1e3 / calls[name] for name, t in times.items()}
    return dict(tree=tree, package=str(Path(port.__file__).parent), model_calls=calls,
                tokens_equal=all(np.array_equal(a, b) for a, b in zip(toks["mesh"], toks["one"])),
                ms_per_model_call=ms, host_ms_added=ms["mesh"] - ms["one"],
                seconds=times, card=_card())


def compare(parent: str) -> int:
    lines = []
    for tree in (parent, ".", ".", parent):
        env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
        run = subprocess.run([sys.executable, __file__, "--tree", tree], env=env,
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        line = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        lines.append(line)
    summary = {}
    for name, tree in (("parent", parent), ("change", ".")):
        runs = [x for x in lines if x["tree"] == tree]
        summary[name] = {k: [x["ms_per_model_call"][k] for x in runs] for k in ("mesh", "one")}
        summary[name]["host_ms_added"] = [x["host_ms_added"] for x in runs]
    print(json.dumps({"summary": summary, "card": lines[0]["card"]}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--tree", help="time the port under this directory")
    group.add_argument("--compare", metavar="PARENT",
                       help="parent, this tree, this tree, parent, one process each")
    args = ap.parse_args()
    if args.compare:
        return compare(args.compare)
    print(json.dumps(time_tree(args.tree)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
