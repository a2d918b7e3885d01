"""Case 17: the persistent serving engine over a mesh.

Port of ``cases/case17_persistent_engine.py``: the continuous engine on a
(2, 4) ``data`` × ``model`` mesh under ``RULES_TP_SERVING`` (tensor
parallelism over heads; the paged pools split over heads), every rank a
thread of this process (``parallel.run_on_threads``: one card carries the
whole mesh), with random weights from a seed. Proven in turn:

1. persistence: a second ``serve`` of the same system prompt is admitted
   against the pages the first one retired, and the cache is created once;
2. streaming arrivals (``add_request``/``step``/``pop_finished``) serve the
   one-shot drain's tokens;
3. the engine's latency telemetry (TTFT, TPOT, queue wait, refill share);
4. recompute preemption under a tight pool serves the roomy pool's tokens;
5. chained decode blocks serve the unchained tokens;

and every rank serves the same. Head dim 64, which the decode-attention
kernel takes, so the same case runs on the card:

    python -m learning_jax_sharding_tpu_torch.cases.case17_persistent_engine [--cuda]
"""

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from learning_jax_sharding_tpu_torch.cases import say
from learning_jax_sharding_tpu_torch.models.serving import ContinuousEngine
from learning_jax_sharding_tpu_torch.models.transformer import CONFIG_TINY, Transformer
from learning_jax_sharding_tpu_torch.parallel import run_on_threads
from learning_jax_sharding_tpu_torch.parallel.logical import RULES_TP_SERVING

CFG = dataclasses.replace(CONFIG_TINY, head_dim=64, decode_attention="blocked")
NEW = 6


def body(mesh):
    params = Transformer(CFG, device="cpu", seed=3).state_dict()
    rng = np.random.default_rng(17)
    system = rng.integers(1, CFG.vocab_size, size=(20,)).astype(np.int32)

    def engine(**kw):
        return ContinuousEngine(CFG, mesh, RULES_TP_SERVING, batch_size=2, max_new_tokens=NEW,
                                refill_chunk=4, **kw)

    # 1. Persistence: prefix hits span serve() calls.
    eng = engine(paged_pages=12, page_size=16, prefix_cache=True)
    out1 = eng.serve(params, [system])
    assert eng.last_stats["prefix_hits"] == 0
    assert eng.last_stats["prefix_pages_retained"] >= 1
    out2 = eng.serve(params, [system.copy()])
    assert eng.last_stats["prefix_hits"] == 1, eng.last_stats
    np.testing.assert_array_equal(out1[0], out2[0])
    assert eng.cache_creations == 1
    say(f"PASS: prefix hit from a previous serve() call ({eng.last_stats['prefix_pages_reused']} "
        "page reused, cache created once)")

    # 2. Streaming arrivals == the one-shot drain.
    prompts = [rng.integers(1, CFG.vocab_size, size=(n,)).astype(np.int32) for n in (3, 9, 5, 12)]
    ref = engine().serve(params, prompts)
    stream = engine()
    rids = [stream.add_request(p) for p in prompts[:2]]
    results, late, steps = {}, list(prompts[2:]), 0
    while stream.has_work() or late:
        stream.step(params)
        results.update(stream.pop_finished())
        steps += 1
        if late and steps >= 2:                  # arrivals while mid-flight
            rids.append(stream.add_request(late.pop(0)))
    for rid, r in zip(rids, ref):
        np.testing.assert_array_equal(results[rid], r)
    say(f"PASS: {len(prompts)} streaming arrivals over {steps} steps serve the one-shot "
        "drain's tokens")

    # 3. Latency telemetry (host clocks: each rank's own).
    lat = stream.latency_stats()
    for key in ("ttft_p50", "tpot_p50", "queue_wait_p50", "refill_frac"):
        assert lat[key] is not None and lat[key] >= 0, (key, lat)
    say(f"PASS: engine telemetry: TTFT p50 {lat['ttft_p50'] * 1e3:.0f} ms, TPOT p50 "
        f"{lat['tpot_p50'] * 1e3:.1f} ms, refill {lat['refill_frac']:.0%} of dispatch time")

    # 4. Recompute preemption is exact.
    fourteen = [rng.integers(1, CFG.vocab_size, size=(14,)).astype(np.int32) for _ in range(2)]
    a = engine(paged_pages=9, page_size=16).serve(params, fourteen)
    tight = engine(paged_pages=4, page_size=16)
    b = tight.serve(params, fourteen)
    assert tight.last_stats["preemptions"] >= 1
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
    say(f"PASS: {tight.last_stats['preemptions']} preemption(s) under a 3-page pool serve "
        "the unpressured engine's tokens")

    # 5. Chained decode blocks are exact.
    c = engine(decode_block_steps=2, decode_chain=4).serve(params, prompts)
    for x, y in zip(ref, c):
        np.testing.assert_array_equal(y, x)
    say("PASS: decode_chain=4 (one host sync a chain) serves the unchained tokens")

    # Every rank decided alike: the same tokens everywhere.
    mine = [np.asarray(t).tolist() for t in ref + b + c]
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    assert all(r == mine for r in ranks)
    say(f"PASS: case17: persistent engine over a {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
        f"mesh of {len(ranks)} ranks: state across calls, streaming admission, telemetry, "
        "exact preemption, chained dispatch; every rank served the same tokens")
    return mine


def main(device_type: str = "cpu"):
    torch.set_num_threads(1)
    return run_on_threads(body, (2, 4), ("data", "model"), device_type=device_type)


if __name__ == "__main__":
    main("cuda" if "--cuda" in sys.argv[1:] else "cpu")
