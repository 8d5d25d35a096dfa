"""PyTorch/CUDA port of awm_tpu for NVIDIA Hopper.

The JAX package ``awm_tpu`` is the reference; each module here keeps its
counterpart's name.  This package imports neither JAX nor ``awm_tpu``: what
it needs from there (configs, the SECDED code, WAV I/O) it keeps as its own
copy.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from awm_tpu_torch.config import PRESETS, Config, get_config

__all__ = ["Config", "get_config", "PRESETS", "__version__"]
