"""Dummy-group and core interactions drawn as an SVG grid (counterpart of
timemachine_tpu/fe/dummy_draw.py): one panel an interaction, the molecule
in one shared 2D projection, core, dummy and interacting atoms coloured as
JAX's; the SVG text is JAX's for the same inputs.
"""

from __future__ import annotations

import numpy as np

from timemachine_torch.chem.periodic import symbol_of
from timemachine_torch.fe.utils import generate_good_rotations, get_romol_conf, recenter_mol


def rgb_to_decimal(x, y, z):
    return x / 255, y / 255, z / 255


def _css(color):
    r, g, b = color
    return f"rgb({int(r * 255)},{int(g * 255)},{int(b * 255)})"


def draw_dummy_core_ixns(mol, core, bonds, dummy_group, color_blind: bool = False) -> str:
    """SVG grid with one panel per interaction in `bonds` (each a tuple of
    atom idxs: bond/angle/proper/improper), coloring core vs dummy vs
    interacting atoms. Returns SVG text."""
    if color_blind:
        COLOR_DUMMY_IXN = rgb_to_decimal(230, 159, 0)
        COLOR_DUMMY_ACTIVE = rgb_to_decimal(240, 228, 66)
        COLOR_DUMMY_INACTIVE = rgb_to_decimal(0, 158, 115)
        COLOR_CORE_ACTIVE = rgb_to_decimal(213, 94, 0)
        COLOR_CORE_INACTIVE = rgb_to_decimal(204, 121, 167)
        COLOR_BOND = (0.96, 0.74, 0)
    else:
        COLOR_DUMMY_IXN = (0, 0.7, 0)
        COLOR_DUMMY_ACTIVE = (0.6, 1, 0.6)
        COLOR_DUMMY_INACTIVE = (0.188, 0.835, 0.784)
        COLOR_CORE_ACTIVE = (0.9, 0.5, 0.5)
        COLOR_CORE_INACTIVE = (1, 0.8, 0.8)
        COLOR_BOND = (0.92, 0.1, 0.95)

    core = set(int(c) for c in np.asarray(core).ravel())
    dummy_group = set(int(d) for d in dummy_group)
    assert len(core & dummy_group) == 0

    bonds = sorted((tuple(int(a) for a in idxs) for idxs in bonds), key=len)

    # one shared 2D projection for all panels
    rot = generate_good_rotations(mol, mol, num_rotations=1, max_rotations=200)[0]
    conf = get_romol_conf(recenter_mol(mol)) @ rot.T
    xy = conf[:, :2]
    span = max(np.abs(xy).max(), 1e-6)

    cell = 250.0
    per_row = 4
    n = len(bonds)
    rows = -(-n // per_row)
    scale = (cell / 2 - 30) / span

    adjacency = {(b.src, b.dst) for b in mol.bonds} | {(b.dst, b.src) for b in mol.bonds}

    panels = []
    for p_idx, atom_idxs in enumerate(bonds):
        ox = (p_idx % per_row) * cell
        oy = (p_idx // per_row) * cell
        pts = xy * scale + np.array([ox + cell / 2, oy + cell / 2])

        parts = []
        # molecule bonds
        for b in mol.bonds:
            p, q = pts[b.src], pts[b.dst]
            parts.append(
                f'<line x1="{p[0]:.1f}" y1="{p[1]:.1f}" x2="{q[0]:.1f}" y2="{q[1]:.1f}" stroke="#999" stroke-width="1"/>'
            )
        # highlighted interaction path
        is_improper = False
        for k in range(len(atom_idxs) - 1):
            i, j = atom_idxs[k], atom_idxs[k + 1]
            if (i, j) not in adjacency:
                if len(atom_idxs) == 4:
                    is_improper = True
                    continue
                raise AssertionError("Bad idxs")
            p, q = pts[i], pts[j]
            parts.append(
                f'<line x1="{p[0]:.1f}" y1="{p[1]:.1f}" x2="{q[0]:.1f}" y2="{q[1]:.1f}" '
                f'stroke="{_css(COLOR_BOND)}" stroke-width="3"/>'
            )
        # atoms
        ixn_set = set(atom_idxs)
        for a in range(mol.num_atoms):
            if a in ixn_set:
                color = COLOR_CORE_ACTIVE if a in core else COLOR_DUMMY_IXN
            elif a in core:
                color = COLOR_CORE_INACTIVE
            elif a in dummy_group:
                color = COLOR_DUMMY_ACTIVE
            else:
                color = COLOR_DUMMY_INACTIVE
            p = pts[a]
            parts.append(f'<circle cx="{p[0]:.1f}" cy="{p[1]:.1f}" r="7" fill="{_css(color)}"/>')
            parts.append(
                f'<text x="{p[0]:.1f}" y="{p[1] + 2.5:.1f}" font-size="6" text-anchor="middle">'
                f"{symbol_of(mol.atoms[a].atomic_num)}{a}</text>"
            )
        label = (
            "improper"
            if is_improper
            else {2: "bond", 3: "angle", 4: "proper"}[len(atom_idxs)]
        )
        parts.append(
            f'<text x="{ox + 8:.1f}" y="{oy + cell - 8:.1f}" font-size="10">{label} {list(atom_idxs)}</text>'
        )
        panels.append("".join(parts))

    width, height = per_row * cell, rows * cell
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width:.0f}" height="{height:.0f}" '
        f'viewBox="0 0 {width:.0f} {height:.0f}"><rect width="100%" height="100%" fill="white"/>'
        + "".join(panels)
        + "</svg>"
    )
