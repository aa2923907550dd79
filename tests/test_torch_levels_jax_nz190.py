"""The port's plain whole-step body against the JAX package's at
nz = 190 on a stretched grid, which the CUDA kernels take with six
level slots a lane: one of the JAX-parity step cases of
tests/test_torch_levels.py (whose docstring says what they hold), in a
file of its own so that the test workers take the cases apart.
"""

from test_torch_levels import hold_to_jax


def test_eager_step_at_nz190_stretched_matches_jax():
    """Six level slots' worth of levels on a stretched grid (0.21 m at
    the surface, thickening with depth), where the reference-average
    prefix is widest (float64 past 217 levels on such a grid is where the
    kernels read aref from device memory).  The profiles' seeded noise
    outweighs the stratification there, so the deep interfaces are close
    to neutral and dbloc is a difference of nearly equal buoyancies: the
    few ulp by which XLA's and torch's EOS round apart grow to ~1e-10 of
    u in two steps, as much as the port's own trajectory moves when its
    initial T is perturbed by 1e-15 relative.  So each field is held
    within the larger of the bar and ten times that spread; the spread
    itself stays tiny, which a semantic difference would not."""
    spread = hold_to_jax(190, 5.0, calibrate=True)
    assert max(spread.values()) < 1e-8, spread
