"""The port's atom mapping (timemachine_torch/fe/atom_mapping.py, its
native McGregor search; tests/test_torch_native_mcs.py holds it to the
pure-Python one) against timemachine_tpu's get_cores: the same
cores in the same order for ethanol -> propane (the RBFE cache's
conformers) and toluene -> phenol (embedded once by the JAX package at
seed 7), under the default settings and two variants. The JAX side runs its
pure-Python search too; tests/test_native_mcs.py holds its native search to
the same cores."""

import numpy as np
import pytest
import torch

from tests.test_torch_chem import EDGE, RING_EDGE, mol_pair
from timemachine_torch.constants import DEFAULT_ATOM_MAPPING_KWARGS
from timemachine_torch.fe.atom_mapping import get_cores as t_get_cores
from timemachine_tpu.constants import DEFAULT_ATOM_MAPPING_KWARGS as J_DEFAULT_KWARGS
from timemachine_tpu.fe.atom_mapping import get_cores as j_get_cores

torch.set_num_threads(1)  # the suite's workers share the host's cores

VARIANTS = {
    "default": {},
    "ring_only_no_core_core": dict(ring_matches_ring_only=True, enforce_core_core=False),
    "chiral_and_planar_off": dict(enforce_chiral=False, disallow_planar_torsion_flips=False),
}


def test_default_kwargs_match_jax():
    assert DEFAULT_ATOM_MAPPING_KWARGS == J_DEFAULT_KWARGS


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("edge", [EDGE, RING_EDGE], ids=["ethanol-propane", "toluene-phenol"])
def test_get_cores_match_jax_in_order(edge, variant, monkeypatch):
    monkeypatch.setenv("TIMEMACHINE_TPU_PURE_PYTHON_MCS", "1")
    (ja, ta), (jb, tb) = mol_pair(edge[0]), mol_pair(edge[1])
    kwargs = {**DEFAULT_ATOM_MAPPING_KWARGS, **VARIANTS[variant]}
    ref, got = j_get_cores(ja, jb, **kwargs), t_get_cores(ta, tb, **kwargs)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
