"""PyTorch and CUDA port of the gossip / push-sum simulator.

The JAX package ``cop5615_gossip_protocol_tpu`` is the reference this port
is held against; the two share no code. This package runs push-sum and
gossip on the implicit full topology and on imp2d/imp3d with offset-pool
delivery and on the six arithmetic lattices with stencil delivery, on an
NVIDIA GPU through the hand-written kernels of ``csrc/``, or on the CPU
through their plain torch versions when asked.
"""

from .config import SimConfig
from .models.runner import RunResult, run
from .ops.topology import build_topology

__all__ = ["SimConfig", "RunResult", "build_topology", "run"]
