"""The port's plain whole-step body against the JAX package's at
nz = 300 on a stretched grid, which the CUDA kernels take with one
column over three warps: one of the JAX-parity step cases of
tests/test_torch_levels.py (whose docstring says what they hold), in a
file of its own so that the test workers take the cases apart.
"""

from test_torch_levels import hold_to_jax


def test_eager_step_at_nz300_stretched_matches_jax():
    """Past 254 levels, where the kernels spread a column over several
    warps (three at nz = 300), on the stretched grid of the nz = 190 case
    (0.13 m at the surface, 15.8 m at the bottom): held as that case is,
    within the larger of the bar and ten times the port's own rounding
    spread."""
    spread = hold_to_jax(300, 5.0, calibrate=True)
    assert max(spread.values()) < 1e-8, spread
