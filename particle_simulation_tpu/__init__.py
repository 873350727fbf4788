"""particle_simulation_tpu: a JAX PIC-MCC plasma simulation framework that
runs on NVIDIA GPUs (and on the CPU for tests).

Brand-new JAX/XLA/Pallas implementation of the capabilities of the CUDA
reference `MagnusMouritzen/particle-simulation` (see SURVEY.md).
"""

from .config import SimConfig
from .state import SimState, setup_particles

__all__ = ["SimConfig", "SimState", "setup_particles"]
__version__ = "0.1.0"
