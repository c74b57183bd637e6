"""Diagnostic figures of a free-energy calculation (counterpart of
timemachine_tpu/fe/plots.py): the pair-BAR work and overlap panels, the
forward/reverse convergence, the HREX diagnostics, the water sampler's
acceptance and a SingleTopology's interpolation schedules.

Every function draws with matplotlib on the Agg backend, imported when the
function is called, never when this module is: a machine without
matplotlib imports the module and fails only at a figure.
`plot_as_png_fxn` renders a figure to PNG bytes, so results stay picklable.
"""

from __future__ import annotations

import io
import warnings
from typing import Optional, Sequence

import numpy as np
from numpy.typing import NDArray

from timemachine_torch.constants import BOLTZ, DEFAULT_TEMP
from timemachine_torch.fe.bar import compute_fwd_and_reverse_df_over_time


class PlotsUnavailableWarning(UserWarning):
    pass


def plots_available(what: str) -> bool:
    """Whether matplotlib imports here; if not, one warning that `what` is
    None for that reason (the estimators' plots on a machine without it)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        warnings.warn(f"matplotlib does not import on this machine: {what} left None", PlotsUnavailableWarning)
        return False
    return True


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_work(w_forward, w_reverse, axes):
    """Forward/reverse work histograms."""
    w_forward = np.asarray(w_forward)
    w_reverse = np.asarray(w_reverse)
    # clip pathological outliers so the histogram stays readable
    finite_f = w_forward[np.isfinite(w_forward)]
    finite_r = w_reverse[np.isfinite(w_reverse)]
    axes.hist(finite_f, alpha=0.5, label="fwd", density=True, bins=20)
    axes.hist(-finite_r, alpha=0.5, label="-rev", density=True, bins=20)
    axes.set_xlabel("work (kT)")
    axes.legend()


def plot_BAR(df, df_err, fwd_delta_u, rev_delta_u, title, axes):
    """Work overlap for one lambda pair."""
    axes.set_title(f"{title}, dG: {df:.2f} +- {df_err:.2f} kTs")
    plot_work(fwd_delta_u, rev_delta_u, axes)


def plot_dG_errs_subfigure(ax, components, lambdas, dG_errs):
    lambdas_mid = [f"{l1:.2f},{l2:.2f}" for l1, l2 in zip(lambdas, lambdas[1:])]
    dG_errs = np.asarray(dG_errs)
    for i, component in enumerate(components):
        ax.plot(np.arange(len(lambdas_mid)), dG_errs[:, i], marker=".", label=component)
    ax.set_xticks(np.arange(len(lambdas_mid)))
    ax.set_xticklabels(lambdas_mid, rotation=90, fontsize=6)
    ax.set_xlabel(r"($\lambda_i$, $\lambda_{i+1}$)")
    ax.set_ylabel(r"$\Delta G$ error (kcal/mol)")
    ax.legend(fontsize=7)


def plot_dG_errs_figure(components, lambdas, dG_err_by_lambda, dG_err_by_component_by_lambda):
    plt = _plt()
    fig, (ax_top, ax_btm) = plt.subplots(2, 1, figsize=(7, 9))
    KCAL = 4.184
    total = np.asarray(dG_err_by_lambda)[:, None] / KCAL
    plot_dG_errs_subfigure(ax_top, ["total"], lambdas, total)
    plot_dG_errs_subfigure(ax_btm, components, lambdas, np.asarray(dG_err_by_component_by_lambda) / KCAL)
    fig.tight_layout()
    return fig


def plot_overlap_summary_subfigure(ax, components, lambdas, overlaps):
    lambdas_mid = [f"{l1:.2f},{l2:.2f}" for l1, l2 in zip(lambdas, lambdas[1:])]
    overlaps = np.asarray(overlaps)
    for i, component in enumerate(components):
        ax.plot(np.arange(len(lambdas_mid)), overlaps[:, i], marker=".", label=component)
    ax.set_xticks(np.arange(len(lambdas_mid)))
    ax.set_xticklabels(lambdas_mid, rotation=90, fontsize=6)
    ax.set_ylim(0.0, 1.05)
    ax.set_xlabel(r"($\lambda_i$, $\lambda_{i+1}$)")
    ax.set_ylabel("pair BAR overlap")
    ax.axhline(0.667, ls="--", color="gray", lw=0.7)
    ax.legend(fontsize=7)


def plot_overlap_summary_figure(components, lambdas, overlap_by_lambda, overlap_by_component_by_lambda):
    plt = _plt()
    fig, (ax_top, ax_btm) = plt.subplots(2, 1, figsize=(7, 9))
    plot_overlap_summary_subfigure(ax_top, ["total"], lambdas, np.asarray(overlap_by_lambda)[:, None])
    plot_overlap_summary_subfigure(ax_btm, components, lambdas, np.asarray(overlap_by_component_by_lambda))
    fig.tight_layout()
    return fig


def plot_overlap_detail_figure(
    components,
    dGs,
    dG_errs,
    u_kln_by_component_by_lambda,
    temperature,
    prefix,
):
    """Work-histogram grid: one panel per lambda pair (total) plus per
    component."""
    plt = _plt()
    u_kln_by_component_by_lambda = np.asarray(u_kln_by_component_by_lambda)
    n_lambdas, n_comp = u_kln_by_component_by_lambda.shape[:2]
    kBT = BOLTZ * temperature

    n_rows = n_lambdas
    n_cols = n_comp + 1
    fig, all_axes = plt.subplots(n_rows, n_cols, figsize=(3 * n_cols, 2.5 * n_rows), squeeze=False)
    for lam_idx in range(n_lambdas):
        u_kln = u_kln_by_component_by_lambda[lam_idx].sum(0)
        w_fwd = u_kln[0, 1] - u_kln[0, 0]
        w_rev = u_kln[1, 0] - u_kln[1, 1]
        df, df_err = dGs[lam_idx] / kBT, dG_errs[lam_idx] / kBT
        plot_BAR(df, df_err, w_fwd, w_rev, f"{prefix} total {lam_idx}", all_axes[lam_idx][0])
        for comp_idx in range(n_comp):
            comp_ukln = u_kln_by_component_by_lambda[lam_idx, comp_idx]
            w_fwd_c = comp_ukln[0, 1] - comp_ukln[0, 0]
            w_rev_c = comp_ukln[1, 0] - comp_ukln[1, 1]
            ax = all_axes[lam_idx][comp_idx + 1]
            ax.set_title(f"{components[comp_idx]} {lam_idx}", fontsize=8)
            plot_work(w_fwd_c, w_rev_c, ax)
    fig.tight_layout()
    return fig


def plot_fwd_reverse_predictions(
    fwd_dgs: NDArray,
    fwd_dg_errs: NDArray,
    rev_dgs: NDArray,
    rev_dg_errs: NDArray,
    energy_type: str = "∆G",
    prefix: str = "",
):
    """Convergence of forward- vs reverse-accumulated estimates
   ."""
    plt = _plt()
    assert len(fwd_dgs) == len(rev_dgs)
    fractions = np.linspace(1.0 / len(fwd_dgs), 1.0, len(fwd_dgs))
    fig, ax = plt.subplots(figsize=(6, 4.5))
    ax.errorbar(fractions, fwd_dgs, yerr=fwd_dg_errs, marker="o", label=f"fwd {energy_type}")
    ax.errorbar(fractions, rev_dgs, yerr=rev_dg_errs, marker="s", label=f"rev {energy_type}")
    ax.axhline(fwd_dgs[-1], ls="--", color="gray", lw=0.7)
    ax.set_xlabel("fraction of frames")
    ax.set_ylabel(f"{energy_type} (kJ/mol)")
    ax.set_title(f"{prefix} convergence")
    ax.legend()
    fig.tight_layout()
    return fig


def plot_forward_and_reverse_dg(
    solvent_ukln_by_lambda: NDArray,
    complex_ukln_by_lambda: Optional[NDArray] = None,
    temperature: float = DEFAULT_TEMP,
    frames_per_step: int = 100,
    prefix: str = "",
):
    """dG (or ddG when both legs given) over accumulating fractions of frames
   ."""
    kBT = BOLTZ * temperature
    solv_fwd, solv_fwd_err, solv_rev, solv_rev_err = compute_fwd_and_reverse_df_over_time(
        solvent_ukln_by_lambda, frames_per_step=frames_per_step
    )
    if complex_ukln_by_lambda is None:
        return plot_fwd_reverse_predictions(
            np.asarray(solv_fwd) * kBT,
            np.asarray(solv_fwd_err) * kBT,
            np.asarray(solv_rev) * kBT,
            np.asarray(solv_rev_err) * kBT,
            energy_type="∆G",
            prefix=prefix,
        )
    comp_fwd, comp_fwd_err, comp_rev, comp_rev_err = compute_fwd_and_reverse_df_over_time(
        complex_ukln_by_lambda, frames_per_step=frames_per_step
    )
    fwd = (np.asarray(comp_fwd) - np.asarray(solv_fwd)) * kBT
    rev = (np.asarray(comp_rev) - np.asarray(solv_rev)) * kBT
    fwd_err = np.sqrt(np.asarray(comp_fwd_err) ** 2 + np.asarray(solv_fwd_err) ** 2) * kBT
    rev_err = np.sqrt(np.asarray(comp_rev_err) ** 2 + np.asarray(solv_rev_err) ** 2) * kBT
    return plot_fwd_reverse_predictions(fwd, fwd_err, rev, rev_err, energy_type="∆∆G", prefix=prefix)


def plot_forward_and_reverse_ddg(
    solvent_ukln_by_lambda: NDArray,
    complex_ukln_by_lambda: NDArray,
    temperature: float = DEFAULT_TEMP,
    frames_per_step: int = 100,
    prefix: str = "",
):
    return plot_forward_and_reverse_dg(
        solvent_ukln_by_lambda,
        complex_ukln_by_lambda,
        temperature=temperature,
        frames_per_step=frames_per_step,
        prefix=prefix,
    )


def plot_chiral_restraint_energies(chiral_energies: NDArray, figsize=(13, 10), prefix: str = ""):
    plt = _plt()
    chiral_energies = np.asarray(chiral_energies)
    fig, ax = plt.subplots(figsize=figsize)
    im = ax.imshow(chiral_energies, aspect="auto", origin="lower", cmap="viridis")
    fig.colorbar(im, ax=ax, label="chiral restraint energy (kJ/mol)")
    ax.set_xlabel("frame")
    ax.set_ylabel("state")
    ax.set_title(f"{prefix} chiral restraint energies")
    fig.tight_layout()
    return fig


def plot_hrex_transition_matrix(
    transition_matrix: NDArray,
    prefix: str = "",
    format_annotation=lambda x: f"{100.0 * x:.2g}",
    annotation_threshold: float = 0.005,
):
    """State-transition probability heatmap."""
    plt = _plt()
    transition_matrix = np.asarray(transition_matrix)
    n = transition_matrix.shape[0]
    fig, ax = plt.subplots(figsize=(max(5, n * 0.4), max(4, n * 0.35)))
    im = ax.imshow(transition_matrix, origin="lower", cmap="Blues", vmin=0.0)
    if n <= 32:
        for i in range(n):
            for j in range(n):
                p = transition_matrix[i, j]
                if p >= annotation_threshold:
                    ax.text(j, i, format_annotation(p), ha="center", va="center", fontsize=6)
    fig.colorbar(im, ax=ax, label="transition probability")
    ax.set_xlabel("from state")
    ax.set_ylabel("to state")
    ax.set_title(f"{prefix} replica transition matrix")
    fig.tight_layout()
    return fig


def plot_hrex_swap_acceptance_rates_convergence(cumulative_swap_acceptance_rates: NDArray, prefix: str = ""):
    plt = _plt()
    rates = np.asarray(cumulative_swap_acceptance_rates)  # (n_iters, n_pairs)
    fig, ax = plt.subplots(figsize=(6, 4.5))
    for pair_idx in range(rates.shape[1]):
        ax.plot(np.arange(1, len(rates) + 1), rates[:, pair_idx], lw=0.8, label=f"pair {pair_idx}")
    ax.set_ylim(0.0, 1.0)
    ax.set_xlabel("iteration")
    ax.set_ylabel("cumulative swap acceptance rate")
    ax.set_title(f"{prefix} HREX swap acceptance")
    if rates.shape[1] <= 16:
        ax.legend(fontsize=6, ncol=2)
    fig.tight_layout()
    return fig


def plot_hrex_replica_state_distribution_heatmap(
    cumulative_replica_state_counts: NDArray,
    lambdas: Sequence[float],
    prefix: str = "",
):
    """Fraction of time each replica spends in each state."""
    plt = _plt()
    counts = np.asarray(cumulative_replica_state_counts)  # (iters, states, replicas)
    final = counts[-1]  # (states, replicas)
    fraction = final / np.maximum(final.sum(0, keepdims=True), 1)
    n = final.shape[0]
    fig, ax = plt.subplots(figsize=(max(5, n * 0.4), max(4, n * 0.35)))
    im = ax.imshow(fraction, origin="lower", cmap="viridis", vmin=0.0)
    fig.colorbar(im, ax=ax, label="fraction of iterations")
    ax.set_xlabel("replica")
    ax.set_ylabel("state")
    ax.set_xticks(np.arange(n))
    ax.set_yticks(np.arange(n))
    ax.set_yticklabels([f"{lam:.2f}" for lam in lambdas], fontsize=6)
    ax.set_title(f"{prefix} replica-state distribution")
    fig.tight_layout()
    return fig


def plot_water_proposals_by_state(lambdas: Sequence[float], proposals_by_state: NDArray, prefix: str = ""):
    """Targeted-insertion acceptance per state."""
    plt = _plt()
    counts = np.asarray(proposals_by_state)  # (n_states, 2): accepted, proposed
    rates = counts[:, 0] / np.maximum(counts[:, 1], 1)
    fig, ax = plt.subplots(figsize=(6, 4.5))
    ax.bar(np.arange(len(lambdas)), rates)
    ax.set_xticks(np.arange(len(lambdas)))
    ax.set_xticklabels([f"{lam:.2f}" for lam in lambdas], rotation=90, fontsize=6)
    ax.set_xlabel("lambda")
    ax.set_ylabel("water move acceptance rate")
    ax.set_title(f"{prefix} water sampling acceptance")
    fig.tight_layout()
    return fig


def plot_as_png_fxn(f, *args, **kwargs) -> bytes:
    """Render a figure-producing function to PNG bytes."""
    plt = _plt()
    fig = f(*args, **kwargs)
    buffer = io.BytesIO()
    if fig is None:
        fig = plt.gcf()
    fig.savefig(buffer, format="png", dpi=110)
    plt.close(fig)
    buffer.seek(0)
    return buffer.read()


# -- single-topology interpolation schedules ----------


def _st_systems_over_lambda(st, n_windows: int):
    lambdas = np.linspace(0.0, 1.0, n_windows)
    return lambdas, [st.setup_intermediate_state(lamb) for lamb in lambdas]


def plot_interpolation_schedule(st, filter_fn, fig_title: str, n_windows: int = 48, cutoff: float | None = None):
    """Parameter trajectories vs lambda for every interpolated term class of
    a SingleTopology, restricted to atoms passing filter_fn(atom_idx)
    (one panel a term class).

    `cutoff` must match the host nonbonded cutoff the simulation runs with
    (the guest w-coordinate plateaus at it); defaults to DEFAULT_NB_CUTOFF."""
    plt = _plt()
    lambdas, systems = _st_systems_over_lambda(st, n_windows)

    # getters take (lambda_index, system); idx getters take the lambda-0 system
    panels = [
        ("bond k", lambda li, s: np.asarray(s.bond.params)[:, 0], lambda s: s.bond.potential.idxs),
        ("bond b0", lambda li, s: np.asarray(s.bond.params)[:, 1], lambda s: s.bond.potential.idxs),
        ("angle k", lambda li, s: np.asarray(s.angle.params)[:, 0], lambda s: s.angle.potential.idxs),
        ("proper k", lambda li, s: np.asarray(s.proper.params)[:, 0], lambda s: s.proper.potential.idxs),
        ("improper k", lambda li, s: np.asarray(s.improper.params)[:, 0], lambda s: s.improper.potential.idxs),
        ("chiral atom k", lambda li, s: np.asarray(s.chiral_atom.params), lambda s: s.chiral_atom.potential.idxs),
        ("nb pair q_ij", lambda li, s: np.asarray(s.nonbonded_pair_list.params)[:, 0], lambda s: s.nonbonded_pair_list.potential.idxs),
        ("nb pair eps_ij", lambda li, s: np.asarray(s.nonbonded_pair_list.params)[:, 2], lambda s: s.nonbonded_pair_list.potential.idxs),
        ("nb pair w", lambda li, s: np.asarray(s.nonbonded_pair_list.params)[:, 3], lambda s: s.nonbonded_pair_list.potential.idxs),
    ]

    # per-ATOM guest<->environment nonbonded interpolation (charge and the 4D
    # lift)
    atom_rows = np.arange(len(st.c_flags))[:, None]
    if cutoff is None:
        from timemachine_torch.constants import DEFAULT_NB_CUTOFF

        cutoff = DEFAULT_NB_CUTOFF
    guest_qw = [
        np.asarray(st._get_guest_params(st.ff.q_handle, st.ff.lj_handle, float(lamb), cutoff)) for lamb in lambdas
    ]
    panels += [
        ("guest atom q", lambda li, s: guest_qw[li][:, 0], lambda s: atom_rows),
        ("guest atom w", lambda li, s: guest_qw[li][:, 3], lambda s: atom_rows),
    ]

    fig, axes = plt.subplots(4, 3, figsize=(13, 13))
    for ax, (name, get_params, get_idxs) in zip(axes.ravel(), panels):
        idxs0 = np.asarray(get_idxs(systems[0]))
        if idxs0.size == 0:
            ax.set_title(f"{name} (none)")
            continue
        keep = [t for t, row in enumerate(np.atleast_2d(idxs0)) if any(filter_fn(int(a)) for a in np.ravel(row))]
        if not keep:
            ax.set_title(f"{name} (filtered out)")
            continue
        traj = np.stack([get_params(li, s) for li, s in enumerate(systems)])  # (L, T)
        for t in keep:
            ax.plot(lambdas, traj[:, t], lw=0.8)
        ax.set_title(f"{name} ({len(keep)} terms)")
        ax.set_xlabel("lambda")
    fig.suptitle(fig_title)
    fig.tight_layout()
    return fig


def plot_core_interpolation_schedule(st, n_windows: int = 48):
    from timemachine_torch.fe.single_topology import AtomMapFlags

    core = {i for i, f in enumerate(st.c_flags) if f == AtomMapFlags.CORE}
    return plot_interpolation_schedule(st, lambda a: a in core, "core interpolation schedule", n_windows)


def plot_dummy_a_interpolation_schedule(st, n_windows: int = 48):
    dummies = st.get_dummy_atoms_a()
    return plot_interpolation_schedule(st, lambda a: a in dummies, "dummy A interpolation schedule", n_windows)


def plot_dummy_b_interpolation_schedule(st, n_windows: int = 48):
    dummies = st.get_dummy_atoms_b()
    return plot_interpolation_schedule(st, lambda a: a in dummies, "dummy B interpolation schedule", n_windows)
