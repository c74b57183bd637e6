"""The offline force-field converters of the port
(timemachine_torch/ff/smirnoff_converter.py, ff/amber_converter.py) against
the JAX package's on inline XML: the unit reduction and quantity parsing,
convert_smirnoff_xml for each charge type (the converted force field also
loads as the port's Forcefield), and convert_amber_xml under both bond-class
methods. JAX's test against the upstream offxml needs a file outside the
repository; these inputs are written here.
"""

import json
import textwrap

import numpy as np
import pytest

from timemachine_torch.ff import amber_converter as tac
from timemachine_torch.ff import smirnoff_converter as tsc
from timemachine_tpu.ff import amber_converter as jac
from timemachine_tpu.ff import smirnoff_converter as jsc

UNIT_EXPRESSIONS = [
    "kilocalories_per_mole",
    "angstrom",
    "kilocalories_per_mole / angstrom ** 2",
    "kilocalorie_per_mole / radian ** 2",
    "degree",
    "nanometer * nanometer",
    "kilojoules_per_mole / nanometer ** 2 * mole",
    "elementary_charge",
    "2.5 * angstroms",
]

QUANTITIES = [
    "1.5",
    "2.0 * angstrom",
    "1.0 * kilocalories_per_mole / angstrom ** 2",
    "109.5 * degree",
    "-0.25 * elementary_charge",
    "0.0 * kilocalories_per_mole",
]

OFFXML = textwrap.dedent(
    """\
    <SMIRNOFF version="0.3" aromaticity_model="OEAroModel_MDL">
     <Bonds version="0.4" potential="harmonic" fractional_bondorder_method="AM1-Wiberg">
      <Bond smirks="[#6X4:1]-[#6X4:2]" id="b1" length="1.527940216866 * angstrom" k="419.9869268191 * angstrom**-2 * mole**-1 * kilocalorie"/>
      <Bond smirks="[#6:1]-[#1:2]" id="b83" length="1.093899492634 * angstrom" k="740.0934137725 * kilocalories_per_mole / angstrom ** 2"/>
     </Bonds>
     <Angles version="0.3" potential="harmonic">
      <Angle smirks="[*:1]~[#6X4:2]-[*:3]" angle="109.5 * degree" k="101.7373362367 * kilocalories_per_mole / radian ** 2" id="a1"/>
      <Angle smirks="[#1:1]-[#6X4:2]-[#1:3]" angle="107.6 * degree" k="75.0 * kilocalories_per_mole / radian ** 2" id="a2"/>
     </Angles>
     <ProperTorsions version="0.3" potential="k*(1+cos(periodicity*theta-phase))">
      <Proper smirks="[*:1]-[#6X4:2]-[#6X4:3]-[*:4]" periodicity1="3" phase1="0.0 * degree" id="t1" k1="0.1 * kilocalories_per_mole" idivf1="1.0"/>
      <Proper smirks="[#6X4:1]-[#6X4:2]-[#6X4:3]-[#6X4:4]" periodicity1="3" phase1="0.0 * degree" id="t2" k1="0.15 * kilocalories_per_mole" idivf1="1.0" periodicity2="2" phase2="180.0 * degree" k2="0.25 * kilocalories_per_mole" idivf2="2.0"/>
     </ProperTorsions>
     <ImproperTorsions version="0.3" potential="k*(1+cos(periodicity*theta-phase))" default_idivf="auto">
      <Improper smirks="[*:1]~[#6X3:2](~[*:3])~[*:4]" periodicity1="2" phase1="180.0 * degree" k1="1.1 * kilocalories_per_mole" id="i1"/>
     </ImproperTorsions>
     <vdW version="0.3" potential="Lennard-Jones-12-6" combining_rules="Lorentz-Berthelot" scale12="0.0" scale13="0.0" scale14="0.5" scale15="1.0" cutoff="9.0 * angstrom" switch_width="1.0 * angstrom" method="cutoff">
      <Atom smirks="[#1:1]" epsilon="0.0157 * kilocalories_per_mole" id="n1" rmin_half="0.6 * angstrom"/>
      <Atom smirks="[#6:1]" epsilon="0.086 * kilocalories_per_mole" id="n16" rmin_half="1.908 * angstrom"/>
      <Atom smirks="[#8:1]" epsilon="0.21 * kilocalories_per_mole" id="n18" sigma="3.0 * angstrom"/>
     </vdW>
    </SMIRNOFF>
    """
)

AMBER_XML = textwrap.dedent(
    """\
    <ForceField>
     <AtomTypes>
      <Type name="ff-N" class="N" element="N" mass="14.01"/>
      <Type name="ff-H" class="H" element="H" mass="1.008"/>
      <Type name="ff-CT" class="CT" element="C" mass="12.01"/>
      <Type name="ff-H1" class="H1" element="H" mass="1.008"/>
      <Type name="ff-C" class="C" element="C" mass="12.01"/>
      <Type name="ff-O" class="O" element="O" mass="16.00"/>
     </AtomTypes>
     <Residues>
      <Residue name="GLY">
       <Atom name="N" type="ff-N"/>
       <Atom name="H" type="ff-H"/>
       <Atom name="CA" type="ff-CT"/>
       <Atom name="HA2" type="ff-H1"/>
       <Atom name="HA3" type="ff-H1"/>
       <Atom name="C" type="ff-C"/>
       <Atom name="O" type="ff-O"/>
       <Bond from="0" to="1"/>
       <Bond from="0" to="2"/>
       <Bond from="2" to="3"/>
       <Bond from="4" to="2"/>
       <Bond from="2" to="5"/>
       <Bond from="5" to="6"/>
       <ExternalBond from="0"/>
       <ExternalBond from="5"/>
      </Residue>
      <Residue name="XYZ">
       <Atom name="C1" type="ff-CT"/>
       <Atom name="H1" type="ff-H1"/>
       <Bond from="0" to="1"/>
      </Residue>
     </Residues>
     <HarmonicBondForce>
      <Bond class1="N" class2="H" length="0.101" k="363171.2"/>
      <Bond class1="N" class2="CT" length="0.1449" k="282001.6"/>
      <Bond class1="CT" class2="H1" length="0.109" k="284512.0"/>
      <Bond class1="CT" class2="C" length="0.1522" k="265265.6"/>
      <Bond class1="C" class2="O" length="0.1229" k="476976.0"/>
     </HarmonicBondForce>
     <NonbondedForce coulomb14scale="0.8333333333333334" lj14scale="0.5">
      <Atom type="ff-N" charge="-0.4157" sigma="0.325" epsilon="0.7113"/>
      <Atom type="ff-H" charge="0.2719" sigma="0.1069" epsilon="0.0657"/>
      <Atom type="ff-CT" charge="-0.0252" sigma="0.3399" epsilon="0.4577"/>
      <Atom type="ff-H1" charge="0.0698" sigma="0.2471" epsilon="0.0657"/>
      <Atom type="ff-C" charge="0.5973" sigma="0.3399" epsilon="0.3598"/>
      <Atom type="ff-O" charge="-0.5679" sigma="0.2959" epsilon="0.8786"/>
     </NonbondedForce>
    </ForceField>
    """
)


@pytest.mark.parametrize("expr", UNIT_EXPRESSIONS)
def test_string_to_unit_matches_jax(expr):
    assert tsc.string_to_unit(expr) == jsc.string_to_unit(expr)


@pytest.mark.parametrize("text", QUANTITIES)
def test_parse_quantity_matches_jax(text):
    assert tsc.parse_quantity(text) == jsc.parse_quantity(text)


@pytest.fixture(scope="module")
def offxml(tmp_path_factory):
    path = tmp_path_factory.mktemp("offxml") / "mini.offxml"
    path.write_text(OFFXML)
    return str(path)


@pytest.mark.parametrize("charge_type", ["CCC", "BCC", "SC"])
def test_convert_smirnoff_xml_matches_jax(offxml, charge_type):
    t, j = tsc.convert_smirnoff_xml(offxml, charge_type), jsc.convert_smirnoff_xml(offxml, charge_type)
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)
    assert len(t["ProperTorsion"]["patterns"][1][1]) == 2  # two periodicities, the second k over its idivf
    assert t["LennardJones"]["props"]["scale14"] == 0.5


def test_converted_ff_loads_as_the_ports_forcefield(offxml, tmp_path):
    from timemachine_torch.ff import Forcefield

    out = tmp_path / "mini.json"
    out.write_text(json.dumps(tsc.convert_smirnoff_xml(offxml, "CCC")))
    ff = Forcefield.load_from_file(str(out))
    assert len(ff.hb_handle.smirks) == 2 and len(ff.lj_handle.smirks) == 3
    np.testing.assert_allclose(np.asarray(ff.hb_handle.params)[1], [740.0934137725 * 418.4, 0.1093899492634])


@pytest.fixture(scope="module")
def amber_xml(tmp_path_factory):
    path = tmp_path_factory.mktemp("amberxml") / "mini_amber.xml"
    path.write_text(AMBER_XML)
    return str(path)


@pytest.mark.parametrize("method", ["harmonic_bond", "template_bond"])
@pytest.mark.parametrize("standard_only", [True, False])
def test_convert_amber_xml_matches_jax(amber_xml, method, standard_only):
    t = tac.convert_amber_xml(amber_xml, method, standard_only=standard_only)
    j = jac.convert_amber_xml(amber_xml, method, standard_only=standard_only)
    assert t == j
    assert sorted(t) == (["GLY"] if standard_only else ["GLY", "XYZ"])
    gly = t["GLY"]
    assert gly["bonds"][3] == (2, 4)  # CT before H1: the bond is written from CA, as dual_sort orders it
    assert gly["atoms"] == ["N", "H", "C", "H", "H", "C", "O"]


def test_dual_sort_matches_jax():
    for args in (("CT", "H1", 2, 4), ("H1", "CT", 4, 2), ("C", "C", 1, 0)):
        assert tac.dual_sort(*args) == jac.dual_sort(*args)
