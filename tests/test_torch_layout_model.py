"""The kernels' two layouts at model level, in float64 on the CPU: a
4-step ``KppModel`` trajectory (pass_impl "eager_step", then "eager") in
``pass_layout`` "z_lanes" against "col_lanes", bit for bit, and against
the JAX ``KppModel`` in "z_lanes" at tests/test_torch_model.py's bar
(rtol 1e-9), with the trap, a land column and current damping (that
file's configuration).  The pass and step bodies of the two layouts are
held in tests/test_torch_layout.py.
"""

import dataclasses

import numpy as np
import pytest

import mckpp_tpu as J
import mckpp_torch as T

import test_torch_model as tm


def layout_cfg(pkg, pass_impl, layout):
    """tests/test_torch_model.py's configuration (the trap, a land column,
    current damping) of ``pkg`` in ``layout``."""
    cfg = tm.configs(pkg, pass_impl, **tm.TRAP_LAND_DAMP)
    return cfg.replace(physics=dataclasses.replace(cfg.physics,
                                                   pass_layout=layout))


@pytest.fixture(scope="module")
def z_lanes_run():
    """4 steps of the port in z_lanes under "eager_step" (one model)."""
    model, st, prm, frc = tm.port_start(layout_cfg(T, "eager_step",
                                                   "z_lanes"))
    return tm.port_run(model, st, prm, frc, 4)


@pytest.mark.parametrize("pass_impl", ["eager_step", "eager"])
def test_model_z_lanes_equals_col_lanes(z_lanes_run, pass_impl):
    """4 steps of ``KppModel`` with the trap, a land column and current
    damping, under the whole-step body and under the batch-level loops:
    z_lanes equals col_lanes bit for bit (every field of the state)."""
    runs = {}
    for layout in ("col_lanes", "z_lanes"):
        if (pass_impl, layout) == ("eager_step", "z_lanes"):
            runs[layout] = tm.fields(z_lanes_run)
            continue
        model, st, prm, frc = tm.port_start(layout_cfg(T, pass_impl,
                                                       layout))
        assert model.cfg.physics.pass_layout == layout
        runs[layout] = tm.fields(tm.port_run(model, st, prm, frc, 4))
    a, b = runs["z_lanes"], runs["col_lanes"]
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert abs(float(a["reset_flag"][0])) == 999.0, "trap did not fire"


def test_model_z_lanes_matches_jax(z_lanes_run):
    """The same 4 steps against the JAX ``KppModel`` in z_lanes (its
    "fused_xla_step", zaxis=1) at rtol 1e-9 with the field scales of
    tests/test_fused_parity.py, kmix/old/new equal."""
    jm, jst, jprm, jfrc = tm.jax_start(layout_cfg(J, "fused_xla_step",
                                                  "z_lanes"))
    assert jm.cfg.physics.pass_layout == "z_lanes"
    ref = tm.jax_run(jm, jst, jprm, jfrc, 4)
    assert abs(float(ref.reset_flag[0])) == 999.0, "trap did not fire"
    assert float(ref.dampu_flag[1]) > 0.0, "damping did not act"
    tm.assert_states_close(z_lanes_run, ref, rtol=1e-9)
