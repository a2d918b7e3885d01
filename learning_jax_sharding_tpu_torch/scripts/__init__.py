"""The port's probe scripts: the launch floor (``perf_call_floor``), the
launch audit at the 1.4B decode shape (``perf_launch_audit``) and the flash
ceiling at long context (``perf_flash_ceiling``, ``perf_flash_ceiling2``);
and the mesh paths across four cards (``mesh_cards``: a (2, 2) mesh of
NCCL ranks against one card). Each is a module of functions with a ``main()`` that runs on the card:
``python -m learning_jax_sharding_tpu_torch.scripts.<name>``. Importing one
runs nothing."""
