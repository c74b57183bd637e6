"""SMARTS/SMIRKS pattern engine: parser + subgraph matcher.

The port's copy of timemachine_tpu/chem/smarts.py.

Native replacement for RDKit's MolFromSmarts/GetSubstructMatches as used by
the forcefield handlers (ref ff/handlers/utils.py:72-106): all matches are
returned non-uniquified, ordered by atom map number, with chirality tags
parsed but ignored (RDKit's default matching behavior).

Supported primitives (the full set used by the shipped forcefields plus the
common extras): `* a A #n X x D H h r R v + - @ @@ $(...)`, element symbols
(aliphatic uppercase / aromatic lowercase), logical operators `! & , ;` with
standard precedence (! > & (or implicit and) > , > ;), bond primitives
`- = # : ~ @ / \\` with the same logical operators, branches, ring-closure
digits, and atom maps `:n`.

Aromaticity is model-parameterized ("mdl" or "am1bcc", see
chem/aromaticity.py) and can be overridden with explicit flag sets — needed
by the iterative AM1BCC aromaticity assignment itself.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

from timemachine_torch.chem.mol import Mol
from timemachine_torch.chem.periodic import ATOMIC_NUM

# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------


class AtomExpr:
    """Boolean expression tree over atom primitives."""

    __slots__ = ("kind", "args")

    def __init__(self, kind, args):
        self.kind = kind  # "or" | "and" | "not" | prim name
        self.args = args

    def __repr__(self):
        return f"({self.kind} {self.args})"


class BondExpr:
    __slots__ = ("kind", "args")

    def __init__(self, kind, args):
        self.kind = kind
        self.args = args


class PatternAtom:
    __slots__ = ("expr", "map_num")

    def __init__(self, expr, map_num=0):
        self.expr = expr
        self.map_num = map_num


class SmartsPattern:
    def __init__(self, atoms, bonds, smarts=""):
        self.atoms: list[PatternAtom] = atoms
        self.bonds: list[tuple[int, int, BondExpr]] = bonds
        self.smarts = smarts
        self.adj: list[list[tuple[int, BondExpr]]] = [[] for _ in atoms]
        for i, j, be in bonds:
            self.adj[i].append((j, be))
            self.adj[j].append((i, be))
        # match ordering: DFS from atom 0, preferring attachment to mapped frontier
        self.order = self._match_order()

    def _match_order(self):
        n = len(self.atoms)
        seen = [False] * n
        order = []
        for root in range(n):
            if seen[root]:
                continue
            stack = [root]
            while stack:
                a = stack.pop()
                if seen[a]:
                    continue
                seen[a] = True
                order.append(a)
                for b, _ in self.adj[a]:
                    if not seen[b]:
                        stack.append(b)
        return order

    @property
    def map_list(self) -> list[int]:
        """Pattern atom indices ordered by map number (ref utils.py:92-98)."""
        idx_map = {pa.map_num: i for i, pa in enumerate(self.atoms) if pa.map_num}
        return [idx_map[k] for k in sorted(idx_map)]


class _Tokenizer:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def peek(self, k=1) -> str:
        return self.s[self.i : self.i + k]

    def next(self, k=1) -> str:
        out = self.s[self.i : self.i + k]
        self.i += k
        return out

    def eof(self) -> bool:
        return self.i >= len(self.s)

    def read_int(self) -> Optional[int]:
        j = self.i
        while j < len(self.s) and self.s[j].isdigit():
            j += 1
        if j == self.i:
            return None
        val = int(self.s[self.i : j])
        self.i = j
        return val


_TWO_LETTER = sorted((s for s in ATOMIC_NUM if len(s) == 2), key=len, reverse=True)


def _parse_atom_primitive(t: _Tokenizer) -> AtomExpr:
    c = t.peek()
    if c == "!":
        t.next()
        return AtomExpr("not", [_parse_atom_primitive(t)])
    if c == "$":
        t.next()
        assert t.next() == "(", "expected ( after $"
        depth = 1
        start = t.i
        while depth:
            ch = t.next()
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
        inner = t.s[start : t.i - 1]
        return AtomExpr("recursive", [parse_smarts(inner)])
    if c == "#":
        t.next()
        return AtomExpr("atomic_num", [t.read_int()])
    if c == "*":
        t.next()
        return AtomExpr("any", [])
    if c == "a":
        t.next()
        return AtomExpr("aromatic", [])
    if c == "A":
        t.next()
        return AtomExpr("aliphatic", [])
    if c == "@":
        if t.peek(2) == "@@":
            t.next(2)
        else:
            t.next()
        return AtomExpr("chirality", [])  # parsed, ignored (RDKit default)
    if c in "+-":
        t.next()
        n = t.read_int()
        if n is None:
            n = 1
            while t.peek() == c:  # ++ / --
                t.next()
                n += 1
        return AtomExpr("charge", [n if c == "+" else -n])
    if c == "X":
        t.next()
        return AtomExpr("connectivity", [t.read_int() or 0])
    if c == "x":
        t.next()
        return AtomExpr("ring_connectivity", [t.read_int()])
    if c == "D":
        t.next()
        return AtomExpr("degree", [t.read_int() or 0])
    if c == "v":
        t.next()
        return AtomExpr("valence", [t.read_int() or 0])
    if c == "H":
        t.next()
        n = t.read_int()
        if n is None:
            # bare H: hydrogen element (common SMARTS convention)
            return AtomExpr("atomic_num", [1])
        return AtomExpr("h_count", [n])
    if c == "h":
        t.next()
        n = t.read_int()
        return AtomExpr("implicit_h", [1 if n is None else n])
    if c == "r":
        t.next()
        return AtomExpr("ring_size", [t.read_int()])
    if c == "R":
        t.next()
        return AtomExpr("ring_count", [t.read_int()])
    # element symbols: two-letter first, then one-letter; lowercase = aromatic
    two = t.peek(2)
    if two in ATOMIC_NUM and len(two) == 2 and two[1].islower() and not two[1].isdigit():
        t.next(2)
        return AtomExpr("element", [ATOMIC_NUM[two], False])
    if c.isupper() and c in ATOMIC_NUM:
        t.next()
        return AtomExpr("element", [ATOMIC_NUM[c], False])
    if c.islower() and c.upper() in ATOMIC_NUM:
        t.next()
        return AtomExpr("element_aromatic", [ATOMIC_NUM[c.upper()]])
    raise ValueError(f"unknown atom primitive at ...{t.s[t.i:]!r} in {t.s!r}")


def _parse_atom_expr(t: _Tokenizer) -> tuple[AtomExpr, int]:
    """Parse bracket-atom body with precedence ! > & (implicit) > , > ; and a
    trailing :map."""

    def parse_and_high():
        terms = [_parse_atom_primitive(t)]
        while not t.eof() and t.peek() not in ",;:]":
            if t.peek() == "&":
                t.next()
            terms.append(_parse_atom_primitive(t))
        return terms[0] if len(terms) == 1 else AtomExpr("and", terms)

    def parse_or():
        terms = [parse_and_high()]
        while not t.eof() and t.peek() == ",":
            t.next()
            terms.append(parse_and_high())
        return terms[0] if len(terms) == 1 else AtomExpr("or", terms)

    def parse_and_low():
        terms = [parse_or()]
        while not t.eof() and t.peek() == ";":
            t.next()
            terms.append(parse_or())
        return terms[0] if len(terms) == 1 else AtomExpr("and", terms)

    expr = parse_and_low()
    map_num = 0
    if t.peek() == ":":
        t.next()
        map_num = t.read_int() or 0
    return expr, map_num


_BOND_CHARS = "-=#:~@/\\"


def _parse_bond_primitive(t: _Tokenizer) -> BondExpr:
    c = t.peek()
    if c == "!":
        t.next()
        return BondExpr("not", [_parse_bond_primitive(t)])
    t.next()
    kind = {
        "-": "single",
        "=": "double",
        "#": "triple",
        ":": "aromatic",
        "~": "any",
        "@": "ring",
        "/": "single",
        "\\": "single",
    }[c]
    return BondExpr(kind, [])


def _parse_bond_expr(t: _Tokenizer) -> Optional[BondExpr]:
    if t.eof() or (t.peek() not in _BOND_CHARS + "!"):
        return None

    def parse_and_high():
        terms = [_parse_bond_primitive(t)]
        while not t.eof() and (t.peek() in _BOND_CHARS + "!" or t.peek() == "&"):
            if t.peek() == "&":
                t.next()
            terms.append(_parse_bond_primitive(t))
        return terms[0] if len(terms) == 1 else BondExpr("and", terms)

    def parse_or():
        terms = [parse_and_high()]
        while not t.eof() and t.peek() == ",":
            t.next()
            terms.append(parse_and_high())
        return terms[0] if len(terms) == 1 else BondExpr("or", terms)

    def parse_and_low():
        terms = [parse_or()]
        while not t.eof() and t.peek() == ";":
            t.next()
            terms.append(parse_or())
        return terms[0] if len(terms) == 1 else BondExpr("and", terms)

    return parse_and_low()


DEFAULT_BOND = BondExpr("or", [BondExpr("single", []), BondExpr("aromatic", [])])


@lru_cache(maxsize=8192)
def parse_smarts(smarts: str) -> SmartsPattern:
    t = _Tokenizer(smarts)
    atoms: list[PatternAtom] = []
    bonds: list[tuple[int, int, BondExpr]] = []
    ring_closures: dict[str, tuple[int, Optional[BondExpr]]] = {}
    stack: list[int] = []
    prev: Optional[int] = None

    while not t.eof():
        c = t.peek()
        if c == "(":
            t.next()
            stack.append(prev)
            continue
        if c == ")":
            t.next()
            prev = stack.pop()
            continue
        pending = _parse_bond_expr(t)
        if t.eof():
            break
        c = t.peek()
        if c.isdigit() or c == "%":
            if c == "%":
                t.next()
                label = t.next(2)
            else:
                label = t.next()
            if label in ring_closures:
                j, first_bond = ring_closures.pop(label)
                be = pending or first_bond or DEFAULT_BOND
                bonds.append((j, prev, be))
            else:
                ring_closures[label] = (prev, pending)
            continue
        if c == "[":
            t.next()
            expr, map_num = _parse_atom_expr(t)
            assert t.next() == "]", f"expected ] in {smarts!r}"
            atoms.append(PatternAtom(expr, map_num))
        else:
            # bare atom outside brackets
            expr = _parse_atom_primitive(t)
            map_num = 0
            atoms.append(PatternAtom(expr, map_num))
        idx = len(atoms) - 1
        if prev is not None:
            bonds.append((prev, idx, pending or DEFAULT_BOND))
        prev = idx

    if ring_closures:
        raise ValueError(f"unclosed ring closure in SMARTS {smarts!r}")
    return SmartsPattern(atoms, bonds, smarts)


# ---------------------------------------------------------------------------
# Matching
# ---------------------------------------------------------------------------


class _MatchContext:
    __slots__ = ("mol", "arom_atoms", "arom_bonds", "recursive_cache", "ring_count")

    def __init__(self, mol: Mol, arom_atoms, arom_bonds):
        self.mol = mol
        self.arom_atoms = arom_atoms
        self.arom_bonds = arom_bonds
        self.recursive_cache: dict = {}
        self.ring_count = None


def _eval_atom(expr: AtomExpr, ctx: _MatchContext, i: int) -> bool:
    mol = ctx.mol
    k = expr.kind
    if k == "and":
        return all(_eval_atom(e, ctx, i) for e in expr.args)
    if k == "or":
        return any(_eval_atom(e, ctx, i) for e in expr.args)
    if k == "not":
        return not _eval_atom(expr.args[0], ctx, i)
    if k == "any":
        return True
    if k == "atomic_num":
        return mol.atoms[i].atomic_num == expr.args[0]
    if k == "element":
        return mol.atoms[i].atomic_num == expr.args[0] and i not in ctx.arom_atoms
    if k == "element_aromatic":
        return mol.atoms[i].atomic_num == expr.args[0] and i in ctx.arom_atoms
    if k == "aromatic":
        return i in ctx.arom_atoms
    if k == "aliphatic":
        return i not in ctx.arom_atoms
    if k == "charge":
        return mol.atoms[i].formal_charge == expr.args[0]
    if k == "connectivity":
        return mol.total_connectivity(i) == expr.args[0]
    if k == "degree":
        return mol.degree(i) == expr.args[0]
    if k == "h_count":
        return mol.total_num_hs(i) == expr.args[0]
    if k == "implicit_h":
        return mol.atoms[i].implicit_h == expr.args[0]
    if k == "ring_size":
        n = expr.args[0]
        if n is None:
            return mol.atom_in_ring(i)
        return n in mol.atom_ring_sizes(i)
    if k == "ring_count":
        n = expr.args[0]
        if n is None:
            return mol.atom_in_ring(i)
        return len([r for r in mol.ring_info() if i in r]) == n
    if k == "ring_connectivity":
        n = expr.args[0]
        if n is None:
            return mol.num_ring_bonds(i) > 0
        return mol.num_ring_bonds(i) == n
    if k == "valence":
        return mol.valence(i) == expr.args[0]
    if k == "chirality":
        return True  # chirality ignored in matching (RDKit default)
    if k == "recursive":
        cache_key = (id(expr.args[0]), i)
        if cache_key not in ctx.recursive_cache:
            ctx.recursive_cache[cache_key] = _has_anchored_match(expr.args[0], ctx, i)
        return ctx.recursive_cache[cache_key]
    raise ValueError(f"unknown atom expr kind {k}")


def _eval_bond(expr: BondExpr, ctx: _MatchContext, i: int, j: int) -> bool:
    mol = ctx.mol
    k = expr.kind
    if k == "and":
        return all(_eval_bond(e, ctx, i, j) for e in expr.args)
    if k == "or":
        return any(_eval_bond(e, ctx, i, j) for e in expr.args)
    if k == "not":
        return not _eval_bond(expr.args[0], ctx, i, j)
    if k == "any":
        return True
    bond = mol.get_bond(i, j)
    if bond is None:
        return False
    aromatic = (min(i, j), max(i, j)) in ctx.arom_bonds
    if k == "single":
        return bond.order == 1 and not aromatic
    if k == "double":
        return bond.order == 2 and not aromatic
    if k == "triple":
        return bond.order == 3
    if k == "aromatic":
        return aromatic or bond.order == 4
    if k == "ring":
        return mol.bond_in_ring(i, j)
    raise ValueError(f"unknown bond expr kind {k}")


def _backtrack(patt: SmartsPattern, ctx: _MatchContext, pos, mapping, used, results, limit=None, anchor=None):
    if pos == len(patt.order):
        results.append(dict(mapping))
        return limit is not None and len(results) >= limit
    pa = patt.order[pos]
    anchors = [(pb, be) for pb, be in patt.adj[pa] if pb in mapping]
    if pos == 0 and anchor is not None:
        candidates = [anchor]
    elif anchors:
        candidates = ctx.mol.neighbors(mapping[anchors[0][0]])
    else:
        candidates = range(ctx.mol.num_atoms)
    for ma in candidates:
        if ma in used:
            continue
        if not _eval_atom(patt.atoms[pa].expr, ctx, ma):
            continue
        ok = True
        for pb, be in patt.adj[pa]:
            if pb in mapping and not _eval_bond(be, ctx, ma, mapping[pb]):
                ok = False
                break
        if not ok:
            continue
        mapping[pa] = ma
        used.add(ma)
        done = _backtrack(patt, ctx, pos + 1, mapping, used, results, limit, anchor)
        del mapping[pa]
        used.discard(ma)
        if done:
            return True
    return False


def _has_anchored_match(patt: SmartsPattern, ctx: _MatchContext, anchor: int) -> bool:
    # recursive SMARTS anchor at pattern atom 0 (which is order[0] iff the
    # pattern is connected starting at 0; parse order guarantees order[0]==0)
    results: list = []
    _backtrack(patt, ctx, 0, {}, set(), results, limit=1, anchor=anchor)
    return bool(results)


def match_smarts(
    mol: Mol,
    smarts: str | SmartsPattern,
    aromaticity: str = "mdl",
    arom_atoms: Optional[set] = None,
    arom_bonds: Optional[set] = None,
    uniquify: bool = False,
) -> list[tuple[int, ...]]:
    """All substructure matches, each a tuple of mol atom indices.

    Tuples are ordered by atom map number if the pattern has maps (SMIRKS),
    else by pattern atom index — the contract of the reference's match_smirks
    (ff/handlers/utils.py:92-106).
    """
    patt = parse_smarts(smarts) if isinstance(smarts, str) else smarts
    if arom_atoms is None:
        arom_atoms = mol.aromatic_atoms(aromaticity)
        arom_bonds = mol.aromatic_bonds(aromaticity)
    ctx = _MatchContext(mol, arom_atoms, arom_bonds or set())
    results: list[dict] = []
    _backtrack(patt, ctx, 0, {}, set(), results)
    map_list = patt.map_list
    out = []
    for mapping in results:
        if map_list:
            out.append(tuple(mapping[k] for k in map_list))
        else:
            out.append(tuple(mapping[k] for k in range(len(patt.atoms))))
    if uniquify:
        seen = set()
        uniq = []
        for m in out:
            key = frozenset(m)
            if key not in seen:
                seen.add(key)
                uniq.append(m)
        return uniq
    return out
