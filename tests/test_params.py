"""Parameters / StepUptakeOpen unit tests (ref parameters.py semantics)."""

import numpy as np
import pytest

from fenics_eff_uptake.params import (Parameters, StepUptakeOpen,
                                          create_depth_variations,
                                          create_geometry_variations,
                                          create_width_variations)


def test_nondim_formulas():
    p = Parameters(mode="adv-diff", U_ref_dim=0.012, D_dim=0.0003)
    p.validate()
    p.nondim()
    assert p.Pe == pytest.approx(0.012 * 1.0 / 0.0003)   # = 40
    assert p.D == pytest.approx(1.0 / p.Pe)
    assert p.mu == pytest.approx(0.0003 * 1.0 / 0.0003)  # mu* = 1
    assert p.Re == pytest.approx(0.012)
    p2 = Parameters(mode="no-adv")
    p2.validate()
    p2.nondim()
    assert p2.D == 1.0 and p2.U_ref == 0.0 and p2.Pe is None


def test_validation_errors():
    with pytest.raises(ValueError):
        Parameters(mode="bogus")
    p = Parameters(mode="no-adv", sulci_w_dim=20.0)  # wider than L
    with pytest.raises(ValueError):
        p.validate()
    p = Parameters(mode="no-adv")
    p.refinement_factor = 0
    with pytest.raises(ValueError):
        p.validate()


def test_dict_roundtrip():
    p = Parameters(mode="adv-diff", sulci_w_dim=0.7, sulci_h_dim=1.3)
    p.validate()
    p.nondim()
    d = p.to_dict()
    assert d["dimensional"]["sulci_w_dim"] == 0.7
    assert "non_dimensional" in d and "Pe" in d["computed_metrics"]
    p2 = Parameters.from_dict(d)
    assert p2.sulci_w_dim == 0.7 and p2.mode == "adv-diff"
    # step-mu serialization (the reference's to_dict crashes on this --
    # SURVEY 5.9 NameError; ours round-trips)
    p.mu_dim = StepUptakeOpen(1.0, 2.5, 4.75, 5.25)
    d2 = p.to_dict()
    assert d2["dimensional"]["mu_dim"]["type"] == "StepUptakeOpen"
    s = StepUptakeOpen.from_dict(d2["dimensional"]["mu_dim"])
    assert s.mu_open == 2.5 and s.xL == 4.75


def test_step_uptake_shape():
    s = StepUptakeOpen(mu_base=1.0, mu_eff_target=3.0,
                       sulcus_left_x=4.75, sulcus_right_x=5.25)
    assert s.L_c == pytest.approx(0.05)   # 0.1 * w
    x = np.linspace(4.0, 6.0, 2001)
    v = s(x)
    # outside the mouth: base
    assert np.allclose(v[x < 4.75], 1.0)
    assert np.allclose(v[x > 5.25], 1.0)
    # mouth centre: full target (d >= L_c)
    assert s(np.array([5.0]))[0] == pytest.approx(3.0)
    # ramp region is between base and target, monotone entering the mouth
    ramp = v[(x > 4.75) & (x < 4.80)]
    assert (ramp >= 1.0 - 1e-12).all() and (ramp <= 3.0 + 1e-12).all()
    assert (np.diff(ramp) >= -1e-12).all()
    # logistic edge value: alpha(edge) = 1/(1+exp(Gamma/2))
    edge_alpha = 1.0 / (1.0 + np.exp(2.5))
    expect_edge = 1.0 + edge_alpha * 2.0
    assert s(np.array([4.7500001]))[0] == pytest.approx(expect_edge,
                                                        rel=1e-4)


def test_geometry_factories():
    base = Parameters(mode="no-adv")
    g = create_geometry_variations(base, max_width=1.0)
    assert len(g) == 23
    assert g["reference"]["sulci_w_dim"] == 0.5
    assert g["reference"]["sulci_h_dim"] == 1.0
    assert g["largest"]["aspect_ratio"] == pytest.approx(2.0)
    g_small = create_geometry_variations(base, include_small=True)
    assert len(g_small) == 29
    assert g_small["small_sq_050"]["is_small"]
    w = create_width_variations(base, [0.2, 0.4])
    assert len(w) == 2 and "width_0p20mm" in w
    d = create_depth_variations(base, [0.5])
    assert d["depth_0p50mm"]["sulci_h_dim"] == 0.5
