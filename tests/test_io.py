"""IO tests: MSH2 round-trip + ingestion, VTK writers, results JSON."""

import os

import numpy as np

from fenics_eff_uptake.meshing.generator import generate_mesh
from fenics_eff_uptake.meshing.geometry import SulcusGeometry
from fenics_eff_uptake.meshing.msh_io import (mesh_from_msh2, read_msh2,
                                                  write_msh2)


def test_msh2_roundtrip(tmp_path):
    md = generate_mesh(width=5.0, height=1.0, sulcus_depth=0.5,
                       sulcus_width=0.5, mesh_size=0.2,
                       refinement_factor=1, domain_type="sulcus")
    path = str(tmp_path / "mesh.msh")
    write_msh2(path, md.vertices, md.cells)
    data = read_msh2(path)
    assert data["vertices"].shape == md.vertices.shape
    assert data["triangles"].shape == md.cells.shape
    assert np.allclose(data["vertices"], md.vertices)
    # full ingestion: markers rebuilt identically
    geom = SulcusGeometry(5.0, 1.0, 0.5, 0.5, 0.2)
    md2 = mesh_from_msh2(path, geom, "sulcus")
    assert md2.num_cells == md.num_cells
    assert abs(md2.cell_areas().sum() - md.cell_areas().sum()) < 1e-12
    # same marker structure (sets may be ordered differently)
    for attr in ("bc_marker", "bottom_marker", "y0_marker"):
        a = np.sort(getattr(md, attr))
        b = np.sort(getattr(md2, attr))
        assert (a == b).all(), attr
    assert len(md2.interior_y0) == len(md.interior_y0)


def test_msh2_tags_preserved(tmp_path):
    # hand-written tiny msh with physical tags on lines
    content = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
4
1 2 2 5 1 1 2 3
2 2 2 5 1 1 3 4
3 1 2 7 2 1 2
4 1 2 8 2 2 3
$EndElements
"""
    path = str(tmp_path / "tiny.msh")
    with open(path, "w") as f:
        f.write(content)
    data = read_msh2(path)
    assert data["triangles"].shape == (2, 3)
    assert (data["triangle_tags"] == 5).all()
    assert data["lines"].shape == (2, 2)
    assert list(data["line_tags"]) == [7, 8]


def test_msh2_native_matches_python(tmp_path, monkeypatch):
    """The C++ parser (feu_msh2_parse) is bit-identical to the Python spec,
    including non-contiguous node ids, skipped element types, and tags."""
    from fenics_eff_uptake.meshing import native
    content = """$MeshFormat
2.2 0 8
$EndMeshFormat
$PhysicalNames
1
2 5 "domain"
$EndPhysicalNames
$Nodes
5
10 0 0 0
2 1 0 0
30 1 1 0
4 0 1 0
7 0.5 0.5 0.25
$EndNodes
$Elements
6
1 15 2 1 10 10
2 2 2 5 1 10 2 30
3 2 2 5 1 10 30 4
4 1 2 7 2 10 2
5 1 2 8 2 2 30
6 2 0 7 30 4
$EndElements
"""
    path = str(tmp_path / "odd.msh")
    with open(path, "w") as f:
        f.write(content)
    nat = native.read_msh2_native(path)
    if nat is None:
        import pytest
        pytest.skip("native msh2 parser unavailable")
    monkeypatch.setenv("FEU_NATIVE_MSHIO", "0")
    py = read_msh2(path)
    for key in ("vertices", "triangles", "triangle_tags", "lines",
                "line_tags"):
        assert np.array_equal(nat[key], py[key]), key
        assert nat[key].dtype == py[key].dtype, key
    assert nat["version"] == py["version"] == "2.2"
    # z coordinate stripped, ids remapped ascending (10 -> index 3)
    assert nat["vertices"].shape == (5, 2)
    assert nat["triangles"].min() >= 0 and nat["triangles"].max() <= 4


def test_msh2_native_refuses_malformed(tmp_path):
    """Truncated/short-line/headerless files must make the native parser
    return None (Python fallback raises) instead of parsing garbage
    across line boundaries (ADVICE r4: unbounded strtod/strtoll)."""
    from fenics_eff_uptake.meshing import native
    probe = str(tmp_path / "probe.msh")
    with open(probe, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n"
                "$Nodes\n1\n1 0 0 0\n$EndNodes\n")
    if native.read_msh2_native(probe) is None:
        import pytest
        pytest.skip("native msh2 parser unavailable")

    cases = {
        # node line missing the y coordinate: the next line's bytes must
        # NOT be consumed as the missing field
        "short_node": "$MeshFormat\n2.2 0 8\n$EndMeshFormat\n"
                      "$Nodes\n2\n1 0\n2 1 0 0\n$EndNodes\n",
        # element line missing connectivity entries
        "short_elem": "$MeshFormat\n2.2 0 8\n$EndMeshFormat\n"
                      "$Nodes\n3\n1 0 0 0\n2 1 0 0\n3 0 1 0\n$EndNodes\n"
                      "$Elements\n1\n1 2 2 5 1 1 2\n$EndElements\n",
        # file truncated mid-token at EOF (NUL-termination regression)
        "truncated": "$MeshFormat\n2.2 0 8\n$EndMeshFormat\n"
                     "$Nodes\n2\n1 0 0 0\n2 1",
        # no $MeshFormat: Python spec returns version=None
        "no_header": "$Nodes\n1\n1 0 0 0\n$EndNodes\n",
        # non-canonical version token: Python carries the raw token "2"
        "bare_version": "$MeshFormat\n2 0 8\n$EndMeshFormat\n"
                        "$Nodes\n1\n1 0 0 0\n$EndNodes\n",
    }
    for name, content in cases.items():
        path = str(tmp_path / f"{name}.msh")
        with open(path, "w") as f:
            f.write(content)
        assert native.read_msh2_native(path) is None, name


def test_msh2_native_roundtrip_large(tmp_path):
    """Round-trip a real generated mesh through the native parser."""
    from fenics_eff_uptake.meshing import native
    md = generate_mesh(width=5.0, height=1.0, sulcus_depth=0.5,
                       sulcus_width=0.5, mesh_size=0.1,
                       refinement_factor=1, domain_type="sulcus")
    path = str(tmp_path / "mesh.msh")
    write_msh2(path, md.vertices, md.cells)
    nat = native.read_msh2_native(path)
    if nat is None:
        import pytest
        pytest.skip("native msh2 parser unavailable")
    assert np.allclose(nat["vertices"], md.vertices)
    assert np.array_equal(nat["triangles"], md.cells)


def test_vtk_writers(tmp_path):
    from fenics_eff_uptake.models.diffusion import pure_diffusion_solve
    from fenics_eff_uptake.utils.vtk import (write_vtk_cell_scalar,
                                                 write_vtk_point_scalar)
    md = generate_mesh(width=2.0, height=1.0, sulcus_depth=0.3,
                       sulcus_width=0.3, mesh_size=0.2,
                       refinement_factor=1, domain_type="sulcus")
    c = pure_diffusion_solve(md, D=1.0, mu=1.0, element="P1")
    p1 = str(tmp_path / "c.vtk")
    write_vtk_point_scalar(p1, c)
    p2 = str(tmp_path / "dom.vtk")
    write_vtk_cell_scalar(p2, md, md.cell_domain)
    for p in (p1, p2):
        txt = open(p).read()
        assert "UNSTRUCTURED_GRID" in txt
        assert f"POINTS {md.num_vertices}" in txt


def test_mesh_visualization_export(tmp_path):
    from fenics_eff_uptake.meshing.visualization import (
        save_mesh_visualization)
    md = generate_mesh(width=3.0, height=1.0, sulcus_depth=0.4,
                       sulcus_width=0.4, mesh_size=0.2,
                       refinement_factor=1, domain_type="sulcus")
    save_mesh_visualization(md, str(tmp_path))
    files = sorted(os.listdir(tmp_path))
    assert "sulcus_mesh.vtk" in files
    assert "sulcus_bc_markers.vtk" in files
    normals = os.listdir(tmp_path / "normals")
    assert any("bottom" in n for n in normals)
    assert any("left" in n for n in normals)
    # normals on the flat bottom point downward
    import numpy as np
    for n in normals:
        if "id4" in n:
            txt = (tmp_path / "normals" / n).read_text()
            vecs = [l.split() for l in
                    txt.split("VECTORS normal double\n")[1].splitlines()]
            vecs = np.array(vecs, dtype=float)
            assert (vecs[:, 1] < 0.5).all()  # mostly downward/outward
