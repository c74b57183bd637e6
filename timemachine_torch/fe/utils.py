"""Ligand/conformer utilities (the port's copy of the conformer, mass, SDF,
seed-hash, bond and 2D-projection helpers of timemachine_tpu/fe/utils.py;
its atom-mapping grid drawing and energy-table helpers are not ported)."""

from __future__ import annotations

import numpy as np

from timemachine_torch.chem.mol import Mol


def get_romol_conf(mol: Mol, conf_id: int = 0) -> np.ndarray:
    """Conformer in nm (ref fe/utils.py get_romol_conf)."""
    del conf_id
    return mol.get_conf()


def set_romol_conf(mol: Mol, conf_nm: np.ndarray, conf_id: int = 0):
    del conf_id
    mol.set_conf(conf_nm)


def get_mol_name(mol: Mol) -> str:
    if mol.name:
        return mol.name
    if "_Name" in mol.props:
        return str(mol.props["_Name"])
    raise KeyError("mol has no name")


def set_mol_name(mol: Mol, name: str):
    mol.name = name


def get_mol_masses(mol: Mol) -> np.ndarray:
    return mol.masses


def read_sdf(path):
    from timemachine_torch.chem.sdf import read_sdf as _read

    return _read(path)


def read_sdf_mols_by_name(path):
    return {get_mol_name(m): m for m in read_sdf(path)}


def bytes_to_id(data: bytes) -> int:
    """Deterministic 64-bit id from bytes (ref fe/utils.py:589-592); used to
    derive per-window seeds symmetric under A->B vs B->A edge direction."""
    import hashlib

    return int(hashlib.sha256(data).hexdigest(), 16) % (2**64 - 1)


def get_romol_bonds(mol: Mol) -> np.ndarray:
    """(B, 2) bond indices (ref fe/utils.py:437-445)."""
    return np.array([[b.src, b.dst] for b in mol.bonds], dtype=np.int32)


def recenter_mol(mol: Mol) -> Mol:
    """A copy of mol with its conformer centred on its centroid."""
    import copy

    mol_copy = copy.deepcopy(mol)
    conf = get_romol_conf(mol)
    mol_copy.set_conf(conf - np.mean(conf, axis=0))
    return mol_copy


def score_2d(conf, norm=2):
    """Crowding of a conformer's 2D projection: low when atoms are spread."""
    score = 0.0
    for idx, (x0, y0, _) in enumerate(conf):
        for x1, y1, _ in conf[idx + 1 :]:
            score += 1 / ((x0 - x1) ** norm + (y0 - y1) ** norm)
    return score / len(conf)


def generate_good_rotations(mol_a, mol_b, num_rotations: int = 3, max_rotations: int = 1000, seed: int = 1234):
    """The num_rotations of max_rotations random rotations (numpy, from
    seed) whose 2D projections of both molecules are least crowded."""
    assert num_rotations < max_rotations
    conf_a = get_romol_conf(mol_a)
    conf_b = get_romol_conf(mol_b)
    rng = np.random.default_rng(seed)

    def random_so3():
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )

    scores, rotations = [], []
    for _ in range(max_rotations):
        r = random_so3()
        scores.append(max(score_2d(conf_a @ r.T), score_2d(conf_b @ r.T)))
        rotations.append(r)
    perm = np.argsort(scores, kind="stable")
    return np.array(rotations)[perm][:num_rotations]


def convert_uIC50_to_kJ_per_mole(amount_in_uM: float, experiment_temp: float = None) -> float:
    """IC50 in uM -> binding potency in kJ/mol."""
    from timemachine_torch import constants

    temp = experiment_temp if experiment_temp is not None else constants.DEFAULT_TEMP
    RT = (constants.BOLTZ * temp) / constants.KCAL_TO_KJ
    return RT * np.log(amount_in_uM * 1e-6) * constants.KCAL_TO_KJ


def convert_uM_to_kJ_per_mole(amount_in_uM: float, experiment_temp: float = None) -> float:
    return convert_uIC50_to_kJ_per_mole(amount_in_uM, experiment_temp=experiment_temp)


def rotate_mol(mol: Mol, rotation_matrix) -> Mol:
    mol_copy = recenter_mol(mol)
    mol_copy.set_conf(get_romol_conf(mol_copy) @ np.asarray(rotation_matrix).T)
    return mol_copy


def plot_atom_mapping_grid(mol_a: Mol, mol_b: Mol, core, num_rotations: int = 3, seed: int = 2022) -> str:
    """SVG grid of 2D projections of mol_a and mol_b with core atoms colored
    consistently across both, drawn without RDKit. Returns the SVG as a string."""
    from timemachine_torch.chem.periodic import symbol_of

    core = np.asarray(core)
    rotations = generate_good_rotations(mol_a, mol_b, num_rotations=num_rotations, seed=seed)

    rng = np.random.default_rng(seed)
    colors = {}
    for (a_idx, b_idx) in core:
        hue = rng.random()
        colors[("a", int(a_idx))] = hue
        colors[("b", int(b_idx))] = hue

    cell_w, cell_h = 260.0, 260.0
    rows = []

    def hue_to_rgb(h):
        import colorsys

        r, g, b = colorsys.hsv_to_rgb(h, 0.55, 0.95)
        return f"rgb({int(r * 255)},{int(g * 255)},{int(b * 255)})"

    def render(mol, tag, rot, ox, oy):
        conf = get_romol_conf(recenter_mol(mol)) @ rot.T
        xy = conf[:, :2]
        span = max(np.abs(xy).max(), 1e-6)
        scale = (cell_w / 2 - 25) / span
        pts = xy * scale + np.array([ox + cell_w / 2, oy + cell_h / 2])
        parts = []
        for b in mol.bonds:
            p, q = pts[b.src], pts[b.dst]
            parts.append(
                f'<line x1="{p[0]:.1f}" y1="{p[1]:.1f}" x2="{q[0]:.1f}" y2="{q[1]:.1f}" stroke="#444" stroke-width="1.2"/>'
            )
        for i, atom in enumerate(mol.atoms):
            p = pts[i]
            key = (tag, i)
            if key in colors:
                parts.append(f'<circle cx="{p[0]:.1f}" cy="{p[1]:.1f}" r="8" fill="{hue_to_rgb(colors[key])}"/>')
            parts.append(
                f'<text x="{p[0]:.1f}" y="{p[1] + 3:.1f}" font-size="7" text-anchor="middle">'
                f"{symbol_of(atom.atomic_num)}{i}</text>"
            )
        return "".join(parts)

    for r_idx, rot in enumerate(rotations):
        oy = r_idx * cell_h
        rows.append(render(mol_a, "a", rot, 0, oy))
        rows.append(render(mol_b, "b", rot, cell_w, oy))

    width, height = 2 * cell_w, len(rotations) * cell_h
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width:.0f}" height="{height:.0f}" '
        f'viewBox="0 0 {width:.0f} {height:.0f}"><rect width="100%" height="100%" fill="white"/>'
        + "".join(rows)
        + "</svg>"
    )


def get_atom_map_colors(core, seed=2022):
    """Matching random RGB per mapped pair: ({a_idx: rgb}, {b_idx: rgb})
   ."""
    rgbs = np.random.default_rng(seed).random((len(core), 3))
    colors_a = {int(a): tuple(rgb.tolist()) for (a, _), rgb in zip(core, rgbs)}
    colors_b = {int(b): tuple(rgb.tolist()) for (_, b), rgb in zip(core, rgbs)}
    return colors_a, colors_b


def generate_bond_idxs_and_colors(mol_a, mol_b, core):
    """Core bonds of mol_a colored by whether the corresponding mol_b bond
    exists: green = consistent, red = breaks under the mapping
   ."""
    on = (144 / 255, 238 / 255, 144 / 255)
    off = (238 / 255, 144 / 255, 144 / 255)
    a_to_b = {int(a): int(b) for a, b in core}
    bond_idxs, bond_colors = [], {}
    for bond_idx, bond in enumerate(mol_a.bonds):
        if bond.src in a_to_b and bond.dst in a_to_b:
            bond_idxs.append(bond_idx)
            mapped = mol_b.get_bond(a_to_b[bond.src], a_to_b[bond.dst])
            bond_colors[bond_idx] = on if mapped is not None else off
    return bond_idxs, bond_colors


def draw_mol(mol: Mol, highlight_atom_idxs=None, atom_colors=None, bond_idxs=None, bond_colors=None,
             show_idxs: bool = False, size: float = 360.0) -> str:
    """Single-molecule 2D SVG depiction drawn without RDKit: the conformer is projected
    through its least-cluttered rotation; highlighted atoms get filled
    circles, highlighted bonds get colored strokes. Returns SVG text."""
    from timemachine_torch.chem.periodic import symbol_of

    highlight = set(int(i) for i in (highlight_atom_idxs or []))
    atom_colors = atom_colors or {}
    bond_colors = dict(bond_colors or {})
    for b in bond_idxs or []:  # highlighted-but-uncolored bonds get a default
        bond_colors.setdefault(int(b), (1.0, 0.83, 0.3))

    rot = generate_good_rotations(mol, mol, num_rotations=1, max_rotations=200)[0]
    xy = (get_romol_conf(recenter_mol(mol)) @ rot.T)[:, :2]
    span = max(np.abs(xy).max(), 1e-6)
    pts = xy * ((size / 2 - 25) / span) + size / 2

    def rgb(c):
        r, g, b = c
        return f"rgb({int(r * 255)},{int(g * 255)},{int(b * 255)})"

    parts = []
    for bond_idx, bond in enumerate(mol.bonds):
        p, q = pts[bond.src], pts[bond.dst]
        stroke = rgb(bond_colors[bond_idx]) if bond_idx in bond_colors else "#444"
        width = 3.0 if bond_idx in bond_colors else 1.2
        parts.append(
            f'<line x1="{p[0]:.1f}" y1="{p[1]:.1f}" x2="{q[0]:.1f}" y2="{q[1]:.1f}" '
            f'stroke="{stroke}" stroke-width="{width}"/>'
        )
    for i, atom in enumerate(mol.atoms):
        p = pts[i]
        if i in atom_colors:
            parts.append(f'<circle cx="{p[0]:.1f}" cy="{p[1]:.1f}" r="9" fill="{rgb(atom_colors[i])}"/>')
        elif i in highlight:
            parts.append(f'<circle cx="{p[0]:.1f}" cy="{p[1]:.1f}" r="9" fill="#ffd54d"/>')
        label = f"{symbol_of(atom.atomic_num)}{i}" if show_idxs else symbol_of(atom.atomic_num)
        parts.append(f'<text x="{p[0]:.1f}" y="{p[1] + 3:.1f}" font-size="8" text-anchor="middle">{label}</text>')
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size:.0f}" height="{size:.0f}" '
        f'viewBox="0 0 {size:.0f} {size:.0f}"><rect width="100%" height="100%" fill="white"/>'
        + "".join(parts)
        + "</svg>"
    )


def draw_mol_idx(mol: Mol, highlight_atom_idxs=None, atom_colors=None, **kwargs) -> str:
    """draw_mol with atom indices in the labels."""
    return draw_mol(mol, highlight_atom_idxs, atom_colors, show_idxs=True, **kwargs)


def plot_atom_mapping(mol_a: Mol, mol_b: Mol, core, seed=2022) -> tuple[str, str]:
    """Consistently colored SVG depictions of both sides of an atom mapping
    (the SVG strings, not a notebook drawing)."""
    core = np.asarray(core)
    colors_a, colors_b = get_atom_map_colors(core, seed)
    bonds_a, bond_colors_a = generate_bond_idxs_and_colors(mol_a, mol_b, core)
    bonds_b, bond_colors_b = generate_bond_idxs_and_colors(mol_b, mol_a, core[:, ::-1])
    svg_a = draw_mol(mol_a, core[:, 0].tolist(), colors_a, bonds_a, bond_colors_a)
    svg_b = draw_mol(mol_b, core[:, 1].tolist(), colors_b, bonds_b, bond_colors_b)
    return svg_a, svg_b


def sanitize_energies(full_us, lamb_idx, cutoff=10000):
    """Replace energies differing from the reference window by > cutoff with
    +inf."""
    ref_us = np.expand_dims(full_us[:, lamb_idx], axis=1)
    abs_us = np.abs(full_us - ref_us)
    return np.where(abs_us < cutoff, full_us, np.inf)


def extract_delta_Us_from_U_knk(U_knk):
    """(K-1, 2, N) fwd/rev delta-U pairs for BAR from a (K, N, K) energy
    matrix."""
    U_knk = np.asarray(U_knk)
    assert U_knk.shape[0] == U_knk.shape[-1]
    K = U_knk.shape[0]

    def delta_U(from_idx, to_idx):
        current = U_knk[from_idx]
        return current[:, to_idx] - current[:, from_idx]

    delta_Us = []
    for lambda_idx in range(K - 1):
        delta_Us.append((delta_U(lambda_idx, lambda_idx + 1), delta_U(lambda_idx + 1, lambda_idx)))
    return np.array(delta_Us)


def _mol_to_sdf_block(mol, conf=None) -> str:
    """Minimal V2000 molblock of one conformer (enough for 3Dmol.js)."""
    conf = mol.get_conf() if conf is None else np.asarray(conf)
    angstrom = conf * 10.0
    name = getattr(mol, "name", None) or "mol"
    # the header line names the JAX package, so both packages' viewer pages are one text
    lines = [name, "  timemachine_tpu", "", f"{mol.num_atoms:3d}{mol.num_bonds:3d}  0  0  0  0  0  0  0  0999 V2000"]
    for i in range(mol.num_atoms):
        x, y, z = angstrom[i]
        lines.append(f"{x:10.4f}{y:10.4f}{z:10.4f} {mol.atoms[i].symbol:<3s} 0  0  0  0  0  0  0  0  0  0  0  0")
    for b in mol.bonds:
        order = int(b.order) if b.order in (1, 2, 3) else 1
        lines.append(f"{b.src + 1:3d}{b.dst + 1:3d}{order:3d}  0")
    lines.append("M  END")
    lines.append("$$$$")
    return "\n".join(lines)


_VIEWER_TEMPLATE = """<!DOCTYPE html><html><head>
<script src="https://cdnjs.cloudflare.com/ajax/libs/3Dmol/2.0.4/3Dmol-min.js"></script>
</head><body><div id="viewer" style="width:100%;height:640px;position:relative"></div>
<script>
const viewer = $3Dmol.createViewer(document.getElementById("viewer"));
{body}
viewer.zoomTo(); viewer.render();
</script></body></html>"""


def view_atom_mapping_3d(mol_a, mol_b, core) -> str:
    """Standalone HTML (3Dmol.js) showing both conformers with mapped atoms
    highlighted in matching colors (capability of reference fe/utils.py
    view_atom_mapping_3d, without the py3Dmol dependency — open the returned
    string in a browser)."""
    import json as _json

    core = np.asarray(core)
    rng = np.random.default_rng(2022)
    colors = [f"#{rng.integers(0x444444, 0xFFFFFF):06x}" for _ in range(len(core))]

    body = []
    for mol_idx, (mol, col) in enumerate(((mol_a, 0), (mol_b, 1))):
        block = _mol_to_sdf_block(mol)
        body.append(f"viewer.addModel({_json.dumps(block)}, 'sdf');")
        body.append(f"viewer.setStyle({{model: {mol_idx}}}, {{stick: {{radius: 0.12}}}});")
        for pair_idx, pair in enumerate(core):
            atom = int(pair[col])
            body.append(
                f"viewer.addStyle({{model: {mol_idx}, serial: {atom}}}, "
                f"{{sphere: {{radius: 0.3, color: '{colors[pair_idx]}'}}}});"
            )
    return _VIEWER_TEMPLATE.replace("{body}", "\n".join(body))


def view_rest_region_3d(single_topology) -> str:
    """Standalone HTML highlighting a SingleTopologyREST hot region on both
    end-state molecules (capability of reference fe/utils.py
    view_rest_region_3d)."""
    import json as _json

    st = single_topology
    region = st.rest_region_atom_idxs
    idxs_a, idxs_b = st.split_combined_idxs(region)

    body = []
    for mol_idx, (mol, idxs) in enumerate(((st.mol_a, idxs_a), (st.mol_b, idxs_b))):
        block = _mol_to_sdf_block(mol)
        body.append(f"viewer.addModel({_json.dumps(block)}, 'sdf');")
        body.append(f"viewer.setStyle({{model: {mol_idx}}}, {{stick: {{radius: 0.12}}}});")
        for atom in idxs:
            body.append(
                f"viewer.addStyle({{model: {mol_idx}, serial: {int(atom)}}}, "
                f"{{sphere: {{radius: 0.35, color: 'orange'}}}});"
            )
    return _VIEWER_TEMPLATE.replace("{body}", "\n".join(body))
