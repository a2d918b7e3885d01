"""Case 14 of the port run whole through its ``main()`` on the CPU: ring
and Ulysses against dense attention on a (2, 4) mesh of thread ranks, their
collectives (2 × (n − 1) hops, four all-to-alls) and both train steps,
whose losses agree (the case's own asserts). Case 10's parts are held by
``tests/test_torch_seq_parallel.py`` (the ring), the flash tests (the
window) and the remat tests (``remat_attention``); the case itself runs
by hand (``--cpu``, about 20 s)."""

import math

from learning_jax_sharding_tpu_torch.cases import case14_sequence_parallel


def test_case14_sequence_parallel_passes():
    out = case14_sequence_parallel.main(device_type="cpu")
    assert out["ring"]["collective-permute"] == 6 and out["ring"]["all-to-all"] == 0
    assert out["ulysses"]["all-to-all"] == 4 and out["ulysses"]["collective-permute"] == 0
    assert math.isclose(out["losses"]["ring"], out["losses"]["ulysses"], rel_tol=1e-5)
