"""Mesher tests: coverage, conformity, markers, quality.

Mirrors the reference's mesh smoke test (mesh.py:743-776) plus real
assertions the reference lacks (SURVEY.md section 4).
"""

import numpy as np
import pytest

from fenics_eff_uptake.meshing.generator import (
    MeshGenerator, generate_mesh, structured_rectangle)
from fenics_eff_uptake.meshing.geometry import SulcusGeometry
from fenics_eff_uptake.meshing.mesh_data import MARKERS


def _boundary_length(md, marker_arr, marker_id):
    e = md.boundary.edges[marker_arr == marker_id]
    v = md.vertices
    return np.linalg.norm(v[e[:, 1]] - v[e[:, 0]], axis=1).sum()


def test_structured_rectangle_basic():
    md = structured_rectangle(2.0, 1.0, 8, 4)
    assert md.num_cells == 8 * 4 * 2
    assert np.all(md.cell_areas() > 0)
    assert abs(md.cell_areas().sum() - 2.0) < 1e-12
    # boundary facet marker lengths
    assert abs(_boundary_length(md, md.bc_marker, MARKERS["left"]) - 1.0) < 1e-12
    assert abs(_boundary_length(md, md.bc_marker, MARKERS["right"]) - 1.0) < 1e-12
    assert abs(_boundary_length(md, md.bc_marker, MARKERS["top"]) - 2.0) < 1e-12
    assert abs(_boundary_length(md, md.bc_marker, MARKERS["bottom"]) - 2.0) < 1e-12


def test_rectangular_unstructured():
    md = generate_mesh(width=5.0, height=1.0, sulcus_depth=1.0,
                       sulcus_width=0.5, mesh_size=0.1,
                       refinement_factor=1, domain_type="rectangular")
    areas = md.cell_areas()
    assert np.all(areas > 0)
    assert abs(areas.sum() - 5.0) < 1e-10
    assert (md.cell_domain == 2).all()
    # all four boundary sides marked, total boundary length = perimeter
    total = sum(_boundary_length(md, md.bc_marker, m) for m in (1, 2, 3, 4))
    assert abs(total - (2 * 5.0 + 2 * 1.0)) < 1e-10


@pytest.mark.parametrize("w,d", [(0.5, 1.0), (1.0, 0.2), (0.1, 2.0),
                                 (0.01, 0.01), (1.0, 0.05)])
def test_sulcus_mesh_geometries(w, d):
    md = generate_mesh(width=5.0, height=1.0, sulcus_depth=d,
                       sulcus_width=w, mesh_size=0.1,
                       refinement_factor=1, domain_type="sulcus")
    areas = md.cell_areas()
    assert np.all(areas > 0), "inverted cells"
    # total area = rectangle + cavity (polygonal approximation of
    # integral of d*sin(pi t) dt * w = 2/pi * w * d)
    cavity_exact = 2.0 / np.pi * w * d
    total = areas.sum()
    assert abs(total - (5.0 + cavity_exact)) < 0.05 * cavity_exact + 1e-8
    # domain markers split at y=0
    assert set(np.unique(md.cell_domain)) <= {1, 2}
    cav_area = areas[md.cell_domain == 1].sum()
    assert abs(cav_area - cavity_exact) < 0.05 * cavity_exact + 1e-8
    # mouth line is a conforming interior interface
    assert md.interior_y0 is not None
    v = md.vertices
    e = md.interior_y0.edges
    mouth_len = np.linalg.norm(v[e[:, 1]] - v[e[:, 0]], axis=1).sum()
    assert abs(mouth_len - w) < 1e-9
    # bc marker 4 covers flat bottom + curve; its length ~ (L - w) + arc
    t = np.linspace(0, 1, 20001)
    arc = np.trapezoid(np.sqrt(w**2 + (d * np.pi * np.cos(np.pi * t))**2), t)
    blen = _boundary_length(md, md.bc_marker, MARKERS["bottom"])
    # polygonal boundary undershoots the true arc; allow 3% of arc length
    assert abs(blen - ((5.0 - w) + arc)) < 0.03 * arc + 1e-8


def test_sulcus_markers_reference_semantics():
    """Corner-exclusion artefacts must match the reference (SURVEY 5.9)."""
    w, d = 0.5, 1.0
    md = generate_mesh(width=5.0, height=1.0, sulcus_depth=d, sulcus_width=w,
                       mesh_size=0.1, refinement_factor=1,
                       domain_type="sulcus")
    xL, xR = 2.25, 2.75
    v = md.vertices
    # bottom_left (5): excludes the facet touching the mouth corner
    e5 = md.boundary.edges[md.bottom_marker == MARKERS["bottom_left"]]
    assert len(e5) > 0
    assert v[e5][:, :, 0].max() < xL - 1e-13  # corner vertex excluded
    # sulcus (6): excludes the two facets touching the corners (y=0 there)
    e6 = md.boundary.edges[md.bottom_marker == MARKERS["sulcus"]]
    assert v[e6][:, :, 1].max() < -1e-13
    # y0 exterior marker covers both flat pieces fully
    l_y0 = _boundary_length(md, md.y0_marker, MARKERS["y0_line"])
    assert abs(l_y0 - (5.0 - w)) < 1e-9


def test_mesh_quality():
    md = generate_mesh(width=5.0, height=1.0, sulcus_depth=1.0,
                       sulcus_width=0.5, mesh_size=0.1,
                       refinement_factor=2, domain_type="sulcus")
    v, c = md.vertices, md.cells
    # minimum angle across the mesh should be decent after smoothing
    angles = []
    for i in range(3):
        a = v[c[:, i]]
        b = v[c[:, (i + 1) % 3]]
        cc = v[c[:, (i + 2) % 3]]
        u1 = b - a
        u2 = cc - a
        cosang = (u1 * u2).sum(1) / (
            np.linalg.norm(u1, axis=1) * np.linalg.norm(u2, axis=1))
        angles.append(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
    min_angle = np.min(angles)
    assert min_angle > 10.0, f"poor quality: min angle {min_angle:.2f} deg"
    # refinement factor produces smaller cells near the sulcus
    geom = md.geom
    centroids = v[c].mean(axis=1)
    # the Distance field tracks the 21 curve nodes; probe near the curve
    # bottom (2.5, -1.0) where the field equals lc_fine (DistMin = w/10)
    near = np.linalg.norm(
        centroids - np.array([2.5, -1.0]), axis=1) < 0.05
    far = centroids[:, 1] > 0.7
    sizes = md.cell_sizes()
    assert sizes[near].mean() < 0.75 * sizes[far].mean()
    assert sizes[near].mean() < 1.6 * (0.1 / 2)  # ~lc_fine-sized cells


def test_generator_front_end():
    gen = MeshGenerator(width=5.0, height=1.0, sulcus_depth=1.0,
                        sulcus_width=0.5, mesh_size=0.1,
                        refinement_factor=1, domain_type="sulcus")
    res = gen.generate_mesh()
    assert res is not None
    for key in ("mesh", "bc_markers", "bottom_segment_markers",
                "y0_markers", "domain_markers", "mesh_info"):
        assert key in res
    info = res["mesh_info"]
    assert info["num_vertices"] > 0 and info["num_cells"] > 0
    assert 0 < info["hmin"] <= info["hmax"]


def test_interior_sulcus_opening_ds_measure():
    """dS(sulcus_opening): marker-8 interior-facet set + its measure.

    The reference builds dS measures from the bottom-segment markers
    (ref mesh.py:721-737); marker 8's strict inequalities (mesh.py:425-453)
    exclude the two corner-touching mouth facets that the full interior-y0
    line includes.
    """
    md = generate_mesh(width=5.0, height=1.0, sulcus_depth=1.0,
                       sulcus_width=0.5, mesh_size=0.1,
                       refinement_factor=1, domain_type="sulcus")
    s8 = md.interior_sulcus_opening()
    iy = md.interior_y0
    assert s8 is not None and iy is not None
    # strict-inequality filter: exactly the two corner-touching facets drop
    assert len(s8) == len(iy) - 2
    v = md.vertices
    x8 = v[s8.edges][:, :, 0]
    eps = 1e-12
    assert (x8 > md.geom.xL + eps).all() and (x8 < md.geom.xR - eps).all()
    # the dS measure over marker 8: total length = mouth width minus the
    # two excluded corner facets
    from fenics_eff_uptake.fem.space import FunctionSpace
    from fenics_eff_uptake.analysis.facets import build_facet_quad
    space = FunctionSpace(md, "P1")
    quad = build_facet_quad(space, s8.cell_plus, s8.local_edge_plus)
    d8 = v[s8.edges[:, 1]] - v[s8.edges[:, 0]]
    expect = float(np.abs(d8[:, 0]).sum())
    total = float(quad.total_length)
    assert abs(total - expect) < 1e-12
    mouth = md.geom.xR - md.geom.xL
    assert total < mouth < total + 4 * md.hmax()
    # '+' side is the channel cell; its outward normal points into the
    # cavity (downward)
    n = np.asarray(quad.normal)
    assert (n[:, 1] < -0.99).all()
