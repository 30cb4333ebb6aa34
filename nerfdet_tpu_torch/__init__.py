"""NeRF-Det in PyTorch for one NVIDIA H100.

The port of the JAX package ``nerfdet_tpu`` (which stays the reference).
It imports neither JAX nor anything of ``nerfdet_tpu``: modules it needs
from there are kept as copies. Public functions keep the JAX package's
channels-last layouts, so the parity tests compare like with like.
"""

__version__ = "0.1.0"
