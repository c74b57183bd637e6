"""The port's entry point timemachine_torch/examples/water_sampling_hrex.py
against the repository's JAX script in examples/, imported by path, its
module attributes patched only here, held the three ways of
tests/test_torch_examples.py:
1. what it builds from its arguments is JAX's: the probe, its water box and
   the λ ladder handed to setup_initial_states (exactly);
2. with the drivers replaced in both packages by recorders that return one
   fixed result, it passes JAX's MDParams and prints JAX's summary lines;
3. it runs end to end on the CPU at a cut depth, finite, and a rerun is
   bitwise.
The HREX example's probe is ethanol (its --smiles), at the RBFE cache's
conformer in both packages, so neither embeds.
"""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_chem import conformer
from tests.test_torch_examples import assert_fields_equal, fixed_hrex_result, jax_example, run_jax_main

torch.set_num_threads(1)  # the suite's workers share the host's cores

PROBE = "CCO"


# -- water_sampling_hrex -------------------------------------------------------------------


@pytest.fixture
def cached_probe(monkeypatch):
    """Both packages' embedders give the probe the cache's conformer."""
    from timemachine_torch.chem import embed as tembed
    from timemachine_tpu.chem import embed as jembed

    for mod in (tembed, jembed):
        monkeypatch.setattr(mod, "embed_mol", lambda mol, seed: mol.set_conf(conformer(PROBE).copy()))


def test_water_sampling_hrex_builds_jax_ladder_and_prints_jax_lines(cached_probe, monkeypatch, capsys):
    from timemachine_torch.examples import water_sampling_hrex as tex

    jex = jax_example("water_sampling_hrex", monkeypatch)
    calls = {}

    def setup_recorder(tag):
        def setup_initial_states(afe, ff, host_config, temperature, lambda_schedule, seed, device=None):
            n = host_config.conf.shape[0]
            calls[tag, "setup"] = (np.asarray(afe.mol.get_conf()), np.asarray(host_config.conf),
                                   np.asarray(host_config.box), temperature, np.asarray(lambda_schedule), seed)
            return [SimpleNamespace(ligand_idxs=np.arange(n, n + afe.mol.num_atoms)) for _ in lambda_schedule]

        return setup_initial_states

    def hrex_recorder(tag):
        def run_sims_hrex(states, md_params):
            calls[tag, "md"] = md_params
            x = np.concatenate([calls[tag, "setup"][1], calls[tag, "setup"][0]])
            frames = np.stack([x + 0.02 * k for k in range(3)])
            return fixed_hrex_result(len(states), frames, np.stack([calls[tag, "setup"][2]] * 3), water=True)

        return run_sims_hrex

    for tag, mod in (("jax", jex), ("port", tex)):
        monkeypatch.setattr(mod, "setup_initial_states", setup_recorder(tag))
        monkeypatch.setattr(mod, "run_sims_hrex", hrex_recorder(tag))
    argv = ["--smiles", PROBE, "--box_width", "2.6", "--n_windows", "4", "--n_frames", "9", "--n_proposals", "120",
            "--seed", "2024"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run_jax_main(jex, argv, monkeypatch)
        j_out = capsys.readouterr().out
        tex.main([*argv, "--device", "cpu"])
        t_out = capsys.readouterr().out
    assert t_out == j_out and "decoupling dG estimate" in t_out
    for got, ref in zip(calls["port", "setup"], calls["jax", "setup"]):
        np.testing.assert_array_equal(got, ref)
    assert_fields_equal(calls["port", "md"], calls["jax", "md"])


def test_water_sampling_hrex_runs_on_the_cpu_bitwise(cached_probe, monkeypatch):
    """A 2.5 nm box (over twice the cutoff), 2 windows, 2 equilibration
    steps and 1 frame of 10, the sampler every 10 steps with 20 proposals;
    the host's FIRE cut to 40 steps at one window (20 leave forces over
    MAX_FORCE_NORM), run once and handed to the rerun as it came out (the
    FIRE is half of a run here; its own tests hold it bitwise)."""
    from timemachine_torch.examples import water_sampling_hrex as tex
    from timemachine_torch.md import minimizer as tmin

    t_fire, fired = tmin.fire_minimize_host, []

    def fire_once(*a, **k):
        if not fired:
            fired.append(t_fire(*a, n_steps_per_window=40, n_windows=1, **k))
        return fired[0].copy()

    monkeypatch.setattr(tmin, "fire_minimize_host", fire_once)
    argv = ["--smiles", PROBE, "--box_width", "2.5", "--n_windows", "2", "--n_frames", "1", "--steps_per_frame", "10",
            "--n_eq_steps", "2", "--water_sampling_interval", "10", "--n_proposals", "20", "--device", "cpu"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        first, again = tex.main(argv), tex.main(argv)
    np.testing.assert_array_equal(first[0].dGs, again[0].dGs)
    assert np.all(np.isfinite(first[0].dGs))
    for a, b in zip(first[1], again[1]):
        np.testing.assert_array_equal(np.asarray(a.frames), np.asarray(b.frames))
        assert np.all(np.isfinite(np.asarray(a.frames)))
    np.testing.assert_array_equal(first[3].cumulative_proposals_by_state(), again[3].cumulative_proposals_by_state())
