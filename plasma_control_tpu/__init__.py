"""plasma_control_tpu — optimal control of 1D electrostatic plasma in JAX.

A brand-new JAX/XLA/Pallas framework with the capabilities of the reference
``ZINZINBIN/Optimal-Control-1D-Electrostatic-Plasma`` (1D Vlasov–Poisson PIC
simulation + Fourier-mode external-field optimal control of the two-stream and
bump-on-tail kinetic instabilities), re-designed as compiled programs:

* circulant-matmul Poisson/gradient field solves instead of Gaussian
  elimination;
* dense shape-function deposition/gather fused by XLA instead of scatter-adds;
* pure-functional symplectic stepping under ``jit``/``vmap``/``lax.scan``;
* batched candidate rollouts + ``shard_map`` device-mesh scaling;
* controllers: FFT phase-conjugate feedback, sampling MPC (MPPI/CEM),
  and JAX/Flax RL (DDPG/TD3-BC, PPO, SAC).
"""

from .config import ControlConfig, MPCConfig, SimConfig, preset
from .ops.grid import Grid, make_grid
from .models.pic import PIC, PlasmaState, init_state, step
from .models.rollout import rollout, rollout_batch

__version__ = "0.1.0"

__all__ = [
    "ControlConfig",
    "MPCConfig",
    "SimConfig",
    "preset",
    "Grid",
    "make_grid",
    "PIC",
    "PlasmaState",
    "init_state",
    "step",
    "rollout",
    "rollout_batch",
]
