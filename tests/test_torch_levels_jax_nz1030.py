"""The port's plain whole-step body against the JAX package's at
nz = 1030 on a uniform grid over 500 m, which the CUDA kernels take
with one column over a cluster of two blocks: one of the JAX-parity step cases of
tests/test_torch_levels.py (whose docstring says what they hold), in a
file of its own so that the test workers take the cases apart.
"""

from test_torch_levels import hold_to_jax


def test_eager_step_at_nz1030_matches_jax():
    """Past 1022 levels, where the kernels spread a column over a cluster
    of 2 blocks: nz = 1030 on a uniform grid over 500 m (0.49 m levels;
    over 1000 m and deeper the trap no longer fires on column 0), held as
    the nz = 190 and 300 cases are, within the larger of the bar and ten
    times the port's own rounding spread (the few ulp by which XLA's and
    torch's EOS round apart reach ~5e-11 of u here)."""
    spread = hold_to_jax(1030, 0.0, calibrate=True, dmax=500.0)
    assert max(spread.values()) < 1e-8, spread
