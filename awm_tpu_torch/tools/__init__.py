"""Command-line drivers of the port (counterparts of the JAX package's
tools/): demo_eval, bit_diagnostic, serve_load, multihost_drill, bench_sweep
and demo_table, each run as
``python -m awm_tpu_torch.tools.<name>``."""
