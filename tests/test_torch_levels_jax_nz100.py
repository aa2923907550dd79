"""The port's plain whole-step body against the JAX package's at
nz = 100 on a uniform grid over 200 m, which the CUDA kernels take
with four level slots a lane: one of the JAX-parity step cases of
tests/test_torch_levels.py (whose docstring says what they hold), in a
file of its own so that the test workers take the cases apart.
"""

from test_torch_levels import NZ, hold_to_jax


def test_eager_step_at_nz100_matches_jax():
    hold_to_jax(NZ, 0.0)
