"""Command-line drivers of the port (counterparts of the JAX package's
tools/): demo_eval, bit_diagnostic, serve_load and multihost_drill, each run as
``python -m awm_tpu_torch.tools.<name>``."""
