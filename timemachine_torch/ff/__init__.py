"""Forcefield: a frozen composition of typed parameter handlers (the port's
copy of timemachine_tpu/ff/__init__.py).

Parity target: reference `timemachine/ff/__init__.py:43-317`. Built-in
forcefields are shipped as JSON under timemachine_tpu/ff/params/ (OpenFF-
derived public parameters, converted from the reference's python-literal
serialization — same numbers, this framework's container)."""

from __future__ import annotations

from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Generic, Optional, TypeVar
from warnings import warn

from timemachine_torch.constants import DEFAULT_FF, DEFAULT_PROTEIN_FF, DEFAULT_WATER_FF
from timemachine_torch.ff import handlers as h
from timemachine_torch.ff.serialize import builtin_params_dir, deserialize_handlers, serialize_handlers

_T = TypeVar("_T")


@dataclass
class ForcefieldParams(Generic[_T]):
    hb_params: _T
    ha_params: _T
    pt_params: _T
    it_params: _T
    q_params: _T
    q_params_intra: _T
    lj_params: _T
    lj_params_intra: _T


def combine_params(a: ForcefieldParams, b: ForcefieldParams) -> ForcefieldParams:
    return ForcefieldParams(
        (a.hb_params, b.hb_params),
        (a.ha_params, b.ha_params),
        (a.pt_params, b.pt_params),
        (a.it_params, b.it_params),
        (a.q_params, b.q_params),
        (a.q_params_intra, b.q_params_intra),
        (a.lj_params, b.lj_params),
        (a.lj_params_intra, b.lj_params_intra),
    )


@dataclass(frozen=True)
class Forcefield:
    hb_handle: Optional[h.HarmonicBondHandler]
    ha_handle: Optional[h.HarmonicAngleHandler]
    pt_handle: Optional[h.ProperTorsionHandler]
    it_handle: Optional[h.ImproperTorsionHandler]
    q_handle: Optional[Any]
    q_handle_intra: Optional[Any]
    lj_handle: Optional[h.LennardJonesHandler]
    lj_handle_intra: Optional[h.LennardJonesIntraHandler]
    env_bcc_handle: Optional[h.EnvironmentBCCPartialHandler]
    protein_ff: str
    water_ff: str

    @classmethod
    def load_from_file(cls, path_or_str) -> "Forcefield":
        """Load a built-in (by name, with or without .py/.json suffix) or a
        file path. Reference .py forcefield files load unchanged."""
        original = str(path_or_str)
        path = Path(path_or_str)
        stem = path.name.removesuffix(".py").removesuffix(".json")
        builtin = builtin_params_dir() / f"{stem}.json"
        if builtin.exists():
            if path.is_file() and path.resolve() != builtin.resolve():
                warn(f"Provided path {original} shares name with built-in forcefield, falling back to built-in")
            handlers, protein_ff, water_ff = deserialize_handlers(builtin.read_text())
            return cls.from_handlers(handlers, protein_ff=protein_ff, water_ff=water_ff)
        if not path.is_file():
            raise ValueError(f"Unable to find {original} in file system or built-in forcefields")
        handlers, protein_ff, water_ff = deserialize_handlers(path.read_text())
        return cls.from_handlers(handlers, protein_ff=protein_ff, water_ff=water_ff)

    @classmethod
    def load_default(cls) -> "Forcefield":
        return cls.load_from_file(DEFAULT_FF)

    @classmethod
    def load_precomputed_default(cls) -> "Forcefield":
        ff = cls.load_default()
        return replace(
            ff,
            q_handle=h.PrecomputedChargeHandler(),
            q_handle_intra=h.PrecomputedChargeIntraHandler(),
        )

    @classmethod
    def from_handlers(cls, ff_handlers, protein_ff: str = DEFAULT_PROTEIN_FF, water_ff: str = DEFAULT_WATER_FF):
        slots: dict[str, Any] = dict(
            hb=None, ha=None, pt=None, it=None, lj=None, lj_intra=None, lj_solv=None,
            q=None, q_intra=None, q_solv=None, env_bcc=None,
        )
        for handle in ff_handlers:
            if isinstance(handle, (h.EnvironmentBCCPartialHandler, h.EnvironmentNNPartialHandler)):
                assert slots["env_bcc"] is None
                slots["env_bcc"] = handle
            elif isinstance(handle, h.HarmonicBondHandler):
                slots["hb"] = handle
            elif isinstance(handle, h.HarmonicAngleHandler):
                slots["ha"] = handle
            elif isinstance(handle, h.ProperTorsionHandler):
                slots["pt"] = handle
            elif isinstance(handle, h.ImproperTorsionHandler):
                slots["it"] = handle
            elif isinstance(handle, h.LennardJonesIntraHandler):
                slots["lj_intra"] = handle
            elif isinstance(handle, h.LennardJonesSolventHandler):
                slots["lj_solv"] = handle
            elif isinstance(handle, h.LennardJonesHandler):
                slots["lj"] = handle
            elif isinstance(
                handle,
                (
                    h.AM1BCCCCCIntraHandler,
                    h.AM1CCCIntraHandler,
                    h.AM1BCCIntraHandler,
                    h.SimpleChargeIntraHandler,
                    h.PrecomputedChargeIntraHandler,
                ),
            ):
                slots["q_intra"] = handle
            elif isinstance(handle, (h.AM1CCCSolventHandler, h.AM1BCCSolventHandler, h.SimpleChargeSolventHandler)):
                slots["q_solv"] = handle
            elif isinstance(
                handle,
                (h.AM1BCCCCCHandler, h.AM1CCCHandler, h.AM1BCCHandler, h.SimpleChargeHandler, h.PrecomputedChargeHandler),
            ):
                slots["q"] = handle

        if slots["lj_intra"] is None and slots["lj"] is not None:
            slots["lj_intra"] = h.LennardJonesIntraHandler(slots["lj"].smirks, slots["lj"].params, slots["lj"].props)
        if slots["q_intra"] is None and slots["q"] is not None:
            q = slots["q"]
            intra_cls = {
                h.AM1BCCCCCHandler: h.AM1BCCCCCIntraHandler,
                h.AM1CCCHandler: h.AM1CCCIntraHandler,
                h.AM1BCCHandler: h.AM1BCCIntraHandler,
                h.SimpleChargeHandler: h.SimpleChargeIntraHandler,
                h.PrecomputedChargeHandler: h.PrecomputedChargeIntraHandler,
            }[type(q)]
            if intra_cls in (h.AM1BCCIntraHandler, h.PrecomputedChargeIntraHandler):
                slots["q_intra"] = intra_cls()
            else:
                slots["q_intra"] = intra_cls(q.smirks, q.params, q.props)

        return cls(
            slots["hb"], slots["ha"], slots["pt"], slots["it"],
            slots["q"], slots["q_intra"], slots["lj"], slots["lj_intra"],
            slots["env_bcc"], protein_ff, water_ff,
        )

    def get_ordered_handles(self):
        return [
            self.hb_handle, self.ha_handle, self.pt_handle, self.it_handle,
            self.q_handle, self.q_handle_intra, self.lj_handle, self.lj_handle_intra,
            self.env_bcc_handle,
        ]

    def get_params(self) -> ForcefieldParams:
        def params(x):
            return x.params if x is not None else None

        return ForcefieldParams(
            params(self.hb_handle), params(self.ha_handle), params(self.pt_handle), params(self.it_handle),
            params(self.q_handle), params(self.q_handle_intra), params(self.lj_handle), params(self.lj_handle_intra),
        )

    def serialize(self, fmt="python") -> str:
        return serialize_handlers(self.get_ordered_handles(), self.protein_ff, self.water_ff, fmt=fmt)


def sanitize_water_ff(water_ff: str) -> str:
    water_ff = water_ff.split("/")[-1]
    if water_ff.lower() in ["tip3p", "tip3pfb"]:
        return "tip3p"
    if water_ff.lower() in ["tip4p", "tip4pew", "tip4pfb"]:
        return "tip4pew"
    return water_ff
