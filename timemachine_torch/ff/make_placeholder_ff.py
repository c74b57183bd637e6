"""The placeholder force field: one wildcard pattern a handler, for tests
that need a valid parameterization rather than physical parameters
(counterpart of timemachine_tpu/ff/make_placeholder_ff.py, whose output is
the shipped placeholder_ff.json).

python -m timemachine_torch.ff.make_placeholder_ff [--out PATH] writes its
serialization (default placeholder_ff.json in the working directory; the
shipped file in the JAX package's tree is left as it is).
"""

from argparse import ArgumentParser
from pathlib import Path

import numpy as np

from timemachine_torch.ff import Forcefield
from timemachine_torch.ff.handlers import (
    HarmonicAngleHandler,
    HarmonicBondHandler,
    ImproperTorsionHandler,
    LennardJonesHandler,
    LennardJonesIntraHandler,
    LennardJonesSolventHandler,
    ProperTorsionHandler,
    SimpleChargeHandler,
    SimpleChargeIntraHandler,
    SimpleChargeSolventHandler,
)
from timemachine_torch.ff.serialize import serialize_handlers


def build_placeholder_ff() -> Forcefield:
    return Forcefield(
        hb_handle=HarmonicBondHandler(smirks=["[*:1]~[*:2]"], params=np.array([[1e5, 1e-1]]), props=None),
        ha_handle=HarmonicAngleHandler(smirks=["[*:1]~[*:2]~[*:3]"], params=np.array([[1e2, np.pi / 2]]), props=None),
        pt_handle=ProperTorsionHandler(smirks=["[*:1]~[*:2]~[*:3]~[*:4]"], params=np.array([[1.0, 0.0, 1]]), props=None),
        it_handle=ImproperTorsionHandler(
            smirks=["[*:1]~[#6X3,#7X3:2](~[*:3])~[*:4]"], params=np.array([[1.0, np.pi, 2]]), props=None
        ),
        q_handle=SimpleChargeHandler(smirks=["[*:1]"], params=np.zeros(1), props=None),
        q_handle_intra=SimpleChargeIntraHandler(smirks=["[*:1]"], params=np.zeros(1), props=None),
        lj_handle=LennardJonesHandler(smirks=["[*:1]"], params=np.array([[0.1, 1.0]]), props=None),
        lj_handle_intra=LennardJonesIntraHandler(smirks=["[*:1]"], params=np.array([[0.1, 1.0]]), props=None),
        env_bcc_handle=None,
        protein_ff="amber99sbildn",
        water_ff="amber14/tip3p",
    )


def serialize_placeholder_ff() -> str:
    """The placeholder force field's JSON, with the solvent charge and LJ variants the shipped file carries."""
    ff = build_placeholder_ff()
    extra = [
        SimpleChargeSolventHandler(smirks=["[*:1]"], params=np.zeros(1), props=None),
        LennardJonesSolventHandler(smirks=["[*:1]"], params=np.array([[0.1, 1.0]]), props=None),
    ]
    handlers = [
        ff.hb_handle, ff.ha_handle, ff.pt_handle, ff.it_handle,
        ff.q_handle, ff.q_handle_intra, ff.lj_handle, ff.lj_handle_intra, *extra,
    ]
    return serialize_handlers(handlers, ff.protein_ff, ff.water_ff, fmt="json")


def main(argv=None):
    parser = ArgumentParser(description="Write the placeholder force field's serialization")
    parser.add_argument("--out", default="placeholder_ff.json")
    out = Path(parser.parse_args(argv).out)
    out.write_text(serialize_placeholder_ff())
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
