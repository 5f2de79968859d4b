"""Parameter model, nondimensionalisation and Robin-coefficient expressions.

JAX counterpart of the reference's ``parameters.py``:
  - ``Parameters``            (ref: parameters.py:92-334)
  - ``StepUptakeOpen``        (ref: parameters.py:24-85) -- here a *vectorised*
    callable evaluated at facet quadrature points in one shot instead of a
    per-point C++->Python UserExpression callback.
  - geometry sweep factories  (ref: parameters.py:342-505)

Everything is plain Python/NumPy on the host; arrays cross to device only
inside assembly.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

__all__ = [
    "StepUptakeOpen",
    "Parameters",
    "create_geometry_variations",
    "create_width_variations",
    "create_depth_variations",
]


class StepUptakeOpen:
    """Smoothed-step Robin coefficient mu(x) on y=0 with one sulcus opening.

    Matches the reference semantics (parameters.py:24-85) exactly:
      mu(x) = mu_base outside [xL, xR]; inside, blends to mu_open with weight
      alpha(x) where alpha ramps 0->1 over width L_c from each mouth edge via a
      logistic in z = d/L_c centred at z=0.5 with steepness Gamma, and
      alpha = 1 for d >= L_c.  L_c defaults to 0.1*w, capped at 0.49*w.

    Unlike the reference's dolfin UserExpression (evaluated point-by-point via
    a C++->Python callback during assembly), this is a vectorised NumPy/JAX
    callable: ``mu(x)`` accepts an array of x-coordinates and returns an array,
    so facet assembly evaluates all quadrature points in one fused op.
    """

    def __init__(self, mu_base, mu_eff_target, sulcus_left_x, sulcus_right_x,
                 L_c=None, Gamma=5.0):
        self.xL = float(sulcus_left_x)
        self.xR = float(sulcus_right_x)
        self.w = self.xR - self.xL
        if self.w <= 0:
            raise ValueError(
                f"sulcus_right_x must be > sulcus_left_x (got w={self.w})")
        self.mu_base = float(mu_base)
        self.mu_open = float(mu_eff_target)  # mouth value, used directly
        self.Gamma = float(Gamma)
        if L_c is None:
            L_c = 0.1 * self.w
        self.L_c = max(0.0, min(float(L_c), 0.49 * self.w))

    def alpha(self, x):
        """Edge-smoothing weight alpha(x) in [0,1]; 0 outside the mouth.

        Vectorised version of parameters.py:57-71.
        """
        x = np.asarray(x, dtype=np.float64)
        inside = (x >= self.xL) & (x <= self.xR)
        if self.L_c <= 0.0:
            return np.where(inside, 1.0, 0.0)
        d = np.minimum(x - self.xL, self.xR - x)  # distance to nearest edge
        z = d / self.L_c
        ramp = 1.0 / (1.0 + np.exp(-self.Gamma * (z - 0.5)))
        a = np.where(d >= self.L_c, 1.0, ramp)
        return np.where(inside, a, 0.0)

    def __call__(self, x):
        """mu(x), vectorised (ref parameters.py:74-81)."""
        x = np.asarray(x, dtype=np.float64)
        inside = (x >= self.xL) & (x <= self.xR)
        a = self.alpha(x)
        blended = (1.0 - a) * self.mu_base + a * self.mu_open
        return np.where(inside, blended, self.mu_base)

    def to_dict(self):
        return {
            "type": "StepUptakeOpen",
            "mu_base": self.mu_base,
            "mu_open": self.mu_open,
            "sulcus_left_x": self.xL,
            "sulcus_right_x": self.xR,
            "L_c": self.L_c,
            "Gamma": self.Gamma,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(d["mu_base"], d["mu_open"], d["sulcus_left_x"],
                   d["sulcus_right_x"], L_c=d.get("L_c"),
                   Gamma=d.get("Gamma", 5.0))


MuLike = Union[float, StepUptakeOpen]


class Parameters:
    """Dimensional inputs + validation + nondimensionalisation.

    Mirrors the reference ``Parameters`` (parameters.py:92-334): H is the
    length scale; Pe = U*H/D, D* = 1/Pe, mu* = mu_dim*H/D, Re = rho*U*H/eta.
    """

    MU_DIM_ADV_DIFF = 0.0003   # gives mu* = 1 (ref parameters.py:96)
    MU_DIM_NO_ADV = 0.0003     # gives mu* = 1 (ref parameters.py:97)
    MU_DIM_NO_UPTAKE = 0.0

    VALID_MODES = {"adv-diff", "no-adv", "no-uptake"}

    VISCOSITY = 1.0
    RHO = 1.0

    def __init__(self, mode="adv-diff",
                 L_dim=10.0, H_dim=1.0,
                 sulci_n=1, sulci_w_dim=0.5, sulci_h_dim=1.0,
                 mesh_size_dim=0.02, refinement_factor=1,
                 U_ref_dim=0.012, D_dim=0.0003):
        if mode not in self.VALID_MODES:
            raise ValueError(
                f"Mode must be one of {self.VALID_MODES}, got '{mode}'")
        self.mode = mode
        self.L_dim = L_dim
        self.H_dim = H_dim
        self.sulci_n = sulci_n
        self.sulci_w_dim = sulci_w_dim
        self.sulci_h_dim = sulci_h_dim
        self.mesh_size_dim = mesh_size_dim
        self.refinement_factor = refinement_factor
        self.U_ref_dim = U_ref_dim
        self.D_dim = D_dim
        mode_mu_map = {
            "adv-diff": self.MU_DIM_ADV_DIFF,
            "no-adv": self.MU_DIM_NO_ADV,
            "no-uptake": self.MU_DIM_NO_UPTAKE,
        }
        self.mu_dim: MuLike = mode_mu_map[mode]

    # -- validation (ref parameters.py:144-198) ---------------------------
    def validate(self):
        self._positive(self.L_dim, "Domain length")
        self._positive(self.H_dim, "Domain height")
        self._non_negative(self.sulci_n, "Number of sulci")
        self._non_negative(self.sulci_h_dim, "Sulcus height")
        self._non_negative(self.sulci_w_dim, "Sulci width")
        if self.sulci_n > 0:
            self._positive(self.sulci_h_dim, "Sulcus height (when sulci defined)")
            self._positive(self.sulci_w_dim, "Sulcus width (when sulci defined)")
            if self.sulci_w_dim * self.sulci_n >= self.L_dim:
                raise ValueError(
                    "Total sulcus width must be less than domain length.")
        self._positive(self.mesh_size_dim, "Mesh size")
        if not isinstance(self.refinement_factor, int) or self.refinement_factor < 1:
            raise ValueError("Refinement factor must be an integer >= 1.")
        min_dim = min(self.L_dim, self.H_dim)
        if self.mesh_size_dim > min_dim / 10:
            warnings.warn(
                f"Mesh size ({self.mesh_size_dim}) is large relative to domain.")
        if self.mesh_size_dim < min_dim / 1000:
            warnings.warn(
                f"Mesh size ({self.mesh_size_dim}) is very small - may be slow.")
        if self.mode in ("adv-diff", "no-uptake"):
            self._non_negative(self.U_ref_dim, "Reference velocity")
        self._non_negative(self.D_dim, "Diffusion coefficient")
        if self.mode == "no-adv" and self.D_dim <= 0:
            raise ValueError(
                "Diffusion coefficient must be > 0 for diffusion-only mode.")
        if self.mode == "no-uptake" and self._mu_scalar() != 0:
            warnings.warn("Setting mu to 0 for no-uptake mode.")
            self.mu_dim = 0.0
        elif self.mode != "no-uptake" and np.isscalar(self.mu_dim):
            self._non_negative(self.mu_dim, "Uptake parameter")

    def _mu_scalar(self):
        return self.mu_dim if np.isscalar(self.mu_dim) else None

    @staticmethod
    def _positive(value, name):
        if value <= 0:
            raise ValueError(f"{name} must be > 0, got {value}")

    @staticmethod
    def _non_negative(value, name):
        if value < 0:
            raise ValueError(f"{name} cannot be negative, got {value}")

    # -- nondimensionalisation (ref parameters.py:200-226) ----------------
    def nondim(self):
        self.L_ref = self.H_dim
        self.L = self.L_dim / self.L_ref
        self.H = self.H_dim / self.L_ref
        self.sulci_h = self.sulci_h_dim / self.L_ref
        self.sulci_w = self.sulci_w_dim / self.L_ref
        self.mesh_size = self.mesh_size_dim / self.L_ref
        if self.mode in ("adv-diff", "no-uptake"):
            self.Pe = (self.U_ref_dim * self.H_dim) / self.D_dim
            self.D = 1.0 / self.Pe
            self.Re = (self.RHO * self.U_ref_dim * self.L_ref) / self.VISCOSITY
            self.mu = self._nondim_mu()
            self.U_ref = 1.0
        else:
            self.D = 1.0
            self.mu = self._nondim_mu()
            self.U_ref = 0.0
            self.Pe = None
            self.Re = None

    def _nondim_mu(self):
        """mu* = mu_dim * H / D, elementwise for step expressions."""
        scale = self.H_dim / self.D_dim
        if np.isscalar(self.mu_dim):
            return float(self.mu_dim) * scale
        if isinstance(self.mu_dim, StepUptakeOpen):
            s = self.mu_dim
            return StepUptakeOpen(s.mu_base * scale, s.mu_open * scale,
                                  s.xL, s.xR, L_c=s.L_c, Gamma=s.Gamma)
        raise TypeError(f"Unsupported mu_dim type: {type(self.mu_dim)}")

    # -- serialisation (ref parameters.py:248-322) -------------------------
    def to_dict(self):
        def mu_entry(m):
            return m.to_dict() if isinstance(m, StepUptakeOpen) else m

        result = {
            "mode": self.mode,
            "dimensional": {
                "L_dim": self.L_dim, "H_dim": self.H_dim,
                "sulci_n": self.sulci_n,
                "sulci_h_dim": self.sulci_h_dim,
                "sulci_w_dim": self.sulci_w_dim,
                "mesh_size_dim": self.mesh_size_dim,
                "refinement_factor": self.refinement_factor,
                "U_ref_dim": self.U_ref_dim, "D_dim": self.D_dim,
                "mu_dim": mu_entry(self.mu_dim),
            },
        }
        if hasattr(self, "L_ref"):
            result["non_dimensional"] = {
                "L_ref": self.L_ref, "L": self.L, "H": self.H,
                "sulci_h": self.sulci_h, "sulci_w": self.sulci_w,
                "mesh_size": self.mesh_size,
                "U_ref": self.U_ref, "D": self.D,
                "mu": mu_entry(self.mu),
            }
        result["computed_metrics"] = {}
        if getattr(self, "Pe", None) is not None:
            result["computed_metrics"]["Pe"] = self.Pe
        if getattr(self, "Re", None) is not None:
            result["computed_metrics"]["Re"] = self.Re
        return result

    @classmethod
    def from_dict(cls, params_dict):
        dim = params_dict.get("dimensional", {})
        mode = params_dict.get("mode", "adv-diff")
        init = {k: v for k, v in dim.items() if k != "mu_dim"}
        init["mode"] = mode
        return cls(**init)

    def get_mesh_generator_params(self):
        """Nondimensional geometry inputs for the mesher (ref parameters.py:324)."""
        return {
            "width": self.L,
            "height": self.H,
            "sulcus_depth": self.sulci_h if self.sulci_n > 0 else 0,
            "sulcus_width": self.sulci_w if self.sulci_n > 0 else 0,
            "mesh_size": self.mesh_size,
            "refinement_factor": self.refinement_factor,
        }

    def __str__(self):
        lines = [f"Simulation Parameters ({self.mode.title()} Mode):",
                 f"  Domain: L={self.L_dim}xH={self.H_dim}mm",
                 f"  Mesh: size={self.mesh_size_dim}mm, "
                 f"refinement={self.refinement_factor}x",
                 f"  Sulci: n={self.sulci_n}, "
                 f"{self.sulci_w_dim}x{self.sulci_h_dim}mm"]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Geometry sweep factories (ref parameters.py:342-505)
# ---------------------------------------------------------------------------

def create_geometry_variations(base_params, max_width=1.0, small_thresh=0.10,
                               include_small=False):
    """23 canonical sulcus geometries in 7 AR categories (+6 'small' panel).

    Same (width, depth, key, description, category) grid as the reference
    (parameters.py:365-412), with identical smallness classification.
    """
    base_config = {
        "L_dim": base_params.L_dim,
        "H_dim": base_params.H_dim,
        "mode": base_params.mode,
    }
    H = float(base_params.H_dim)
    L = float(base_params.L_dim)

    def classify_small(w_mm, h_mm):
        w_over_H = w_mm / H
        h_over_H = h_mm / H
        is_small = max(w_over_H, h_over_H) <= small_thresh
        reason = (f"max(w/H, h/H) = {max(w_over_H, h_over_H):.3f} "
                  f"{'<= ' if is_small else '> '} {small_thresh:.2f}")
        return is_small, w_over_H, h_over_H, reason

    variations = [
        # VERY WIDE (AR <= 0.5)
        (1.0, 0.2, "very_wide_tiny", "Very wide, tiny depth (AR=0.2)", "very_wide"),
        (1.0, 0.3, "very_wide_medium", "Very wide, medium depth (AR=0.3)", "very_wide"),
        (1.0, 0.5, "very_wide_large", "Very wide, large depth (AR=0.5)", "very_wide"),
        # MODERATELY WIDE (0.5 < AR <= 1.0)
        (0.5, 0.3, "mod_wide_small", "Moderately wide, small (AR=0.6)", "mod_wide"),
        (0.8, 0.6, "mod_wide_medium", "Moderately wide, medium (AR=0.75)", "mod_wide"),
        (1.0, 0.9, "mod_wide_large", "Moderately wide, large (AR=0.9)", "mod_wide"),
        # SQUARE (AR ~ 1.0)
        (0.2, 0.2, "square_small", "Small square sulcus (AR=1.0)", "square"),
        (0.5, 0.5, "square_medium", "Medium square sulcus (AR=1.0)", "square"),
        (0.7, 0.7, "square_large", "Large square sulcus (AR=1.0)", "square"),
        # MODERATELY DEEP (1.0 < AR <= 2.0)
        (0.5, 0.8, "mod_deep_small", "Moderately deep, small width (AR=1.6)", "mod_deep"),
        (0.5, 1.0, "reference", "Reference case (AR=2.0)", "mod_deep"),
        (1.0, 1.5, "mod_deep_large", "Moderately deep, large width (AR=1.5)", "mod_deep"),
        # DEEP (2.0 < AR <= 5.0)
        (0.3, 1.0, "deep_small", "Deep, small width (AR=3.3)", "deep"),
        (0.5, 1.5, "deep_medium", "Deep, medium width (AR=3.0)", "deep"),
        (0.4, 2.0, "deep_large", "Deep, large depth (AR=5.0)", "deep"),
        # VERY DEEP (AR > 5.0)
        (0.25, 1.5, "very_deep_small", "Very deep, small (AR=6.0)", "very_deep"),
        (0.15, 1.8, "very_deep_large", "Very deep, large (AR=12.0)", "very_deep"),
        (0.1, 2.0, "very_deep_extreme", "Very deep, extreme (AR=20.0)", "very_deep"),
        # SPECIAL CASES
        (1.0, 0.05, "micro_depth_wide", "Micro depth, wide (AR=0.05)", "special"),
        (0.05, 1.0, "micro_width_deep", "Micro width, deep (AR=20.0)", "special"),
        (1.0, 2.0, "largest", "Largest sulcus, deep (AR=2.0)", "special"),
        (0.01, 0.01, "micro_square", "Micro square sulcus (AR=1.0)", "special"),
        (1.0, 1.0, "macro_square", "Macro square sulcus (AR=1.0)", "special"),
    ]

    small_panel = [
        (0.03, 0.03, "small_sq_030", "Small square (0.03 mm)", "small"),
        (0.05, 0.05, "small_sq_050", "Small square (0.05 mm)", "small"),
        (0.08, 0.08, "small_sq_080", "Small square (0.08 mm)", "small"),
        (0.10, 0.10, "small_sq_100", "Small square (0.10 mm)", "small"),
        (0.10, 0.05, "small_wide_100x050", "Small wide, shallow", "small"),
        (0.05, 0.10, "small_deep_050x100", "Small narrow, deeper", "small"),
    ]
    if include_small:
        variations = variations + small_panel

    configs = {}
    for width, depth, key, desc_template, ar_category in variations:
        actual_width = min(width, max_width)
        aspect_ratio = depth / actual_width if actual_width > 0 else float("inf")
        is_small, w_over_H, h_over_H, reason = classify_small(actual_width, depth)
        description = (f"{desc_template} ({actual_width:.2f}x{depth:.2f} mm, "
                       f"AR={aspect_ratio:.2f})")
        configs[key] = {
            **base_config,
            "sulci_w_dim": actual_width,
            "sulci_h_dim": depth,
            "name": description,
            "aspect_ratio": aspect_ratio,
            "aspect_ratio_category": ar_category,
            "width_ratio_L": actual_width / L,
            "width_over_H": w_over_H,
            "depth_over_H": h_over_H,
            "depth_ratio": depth / H,
            "is_small": is_small,
            "smallness_reason": reason,
            "small_threshold": small_thresh,
        }
    return configs


def _base_sweep_config(base_params):
    return {
        "L_dim": base_params.L_dim,
        "H_dim": base_params.H_dim,
        "sulci_n": base_params.sulci_n,
        "mesh_size_dim": base_params.mesh_size_dim,
        "refinement_factor": base_params.refinement_factor,
        "U_ref_dim": base_params.U_ref_dim,
        "D_dim": base_params.D_dim,
        "mode": base_params.mode,
    }


def create_width_variations(base_params, widths, fixed_depth=None):
    """Configs with varying sulcus width, fixed depth (ref parameters.py:451)."""
    if fixed_depth is None:
        fixed_depth = base_params.sulci_h_dim
    base_config = _base_sweep_config(base_params)
    configs = {}
    for width in widths:
        key = f"width_{width:.2f}mm".replace(".", "p")
        configs[key] = {
            **base_config,
            "sulci_w_dim": width,
            "sulci_h_dim": fixed_depth,
            "name": f"Width variation ({width}x{fixed_depth}mm)",
        }
    return configs


def create_depth_variations(base_params, depths, fixed_width=None):
    """Configs with varying sulcus depth, fixed width (ref parameters.py:479)."""
    if fixed_width is None:
        fixed_width = base_params.sulci_w_dim
    base_config = _base_sweep_config(base_params)
    configs = {}
    for depth in depths:
        key = f"depth_{depth:.2f}mm".replace(".", "p")
        configs[key] = {
            **base_config,
            "sulci_w_dim": fixed_width,
            "sulci_h_dim": depth,
            "name": f"Depth variation ({fixed_width}x{depth}mm)",
        }
    return configs
