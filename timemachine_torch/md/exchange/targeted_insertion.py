"""The TIBD water sampler as a Context mover (counterpart of
timemachine_tpu/md/exchange/targeted_insertion.py): every `interval` MD
steps, n_proposals targeted-insertion / biased-deletion proposals, their
semantics those of the prototype in md/exchange/exchange_mover.py.

A firing stays on the device: the full (W,) weights are built once,
chunked over waters; each proposal's region partition, biased deletion
(Gumbel-max over the source region's weights: JAX's categorical), site,
rotation, incremental weight update and Metropolis test are tensor
operations with torch.where for the branches, so no proposal waits on the
host. The outer site is JAX's bounded rejection: the first of 65 uniform
draws in the box that lies outside the sphere, else the 65th. Every draw of
a firing comes from the state's torch.Generator, seeded from the mover's
seed and carried across firings, in one call before the proposals
(ROADMAP P28): JAX folds a key per step and per mover instead. A firing
computes in float64 on every device, its coordinates returned in their own
dtype (ROADMAP P29): JAX's runs in its working dtype, where a water that
clashes (a weight of 1e6 kT) leaves its neighbours' carried weights off by
a few hundredths of a kT once it moves.

The mover works on one system (x (N, 3), a state of shape ()) or on K
replicas at once (x (K, N, 3), a state of shape (K,): BatchedContext), the
proposals of all replicas in one pass, so a firing's launches do not grow
with K. Its nonbonded parameters live in the state (`params`), so HREX
swaps them per state without rebuilding the mover.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from timemachine_torch.constants import BOLTZ
from timemachine_torch.md.exchange.exchange_mover import WaterWeights, quaternion_to_rotation

OUTER_TRIES = 65  # JAX's _outer_point: one draw, then at most 64 more
# uniforms of one proposal before the Gumbel block: the direction, the sphere's radius, the Metropolis test
_U_DIR, _U_SPHERE, _U_ACC, _U_OUTER = 0, 1, 2, 3
_U_GUMBEL = _U_OUTER + 3 * OUTER_TRIES
_N_NORMAL = 7  # the sphere's direction (3), the rotation's quaternion (4)
FIRING_DTYPE = torch.float64  # a firing's arithmetic, whatever the coordinates' dtype


def water_sampler_seed(integrator_seed: int) -> int:
    """The mover's seed of a state: the first int32 of default_rng(the integrator's seed)."""
    return int(np.random.default_rng(integrator_seed).integers(np.iinfo(np.int32).max))


@dataclass
class TIBDState:
    n_accepted: torch.Tensor  # int32, shape ()
    n_proposed: torch.Tensor  # int32
    params: torch.Tensor  # (*shape, N, 4) the sampler's nonbonded parameters
    generator: torch.Generator  # every draw of a firing


@dataclass(eq=False)
class TIBDExchangeMove:
    """n_proposals TIBD water exchanges every `interval` steps, the
    constructor's arguments those of the JAX mover (fe/free_energy.py
    get_context). batch_size is kept for its signature; a firing's
    proposals run in one pass."""

    # teleports waters beyond any list's skin: the Context rebuilds its
    # providers' lists after this mover fires
    moves_atoms_nonlocally = True

    n_atoms: int
    ligand_idxs: np.ndarray
    water_idxs: list  # (W, 3) or a list of 3-arrays
    params: np.ndarray  # (N, 4)
    temperature: float
    beta: float  # nonbonded beta
    cutoff: float
    radius: float
    seed: int
    n_proposals: int = 1000
    interval: int = 400
    batch_size: int = 250

    def __post_init__(self):
        self.water_idxs = np.asarray([np.asarray(g) for g in self.water_idxs], dtype=np.int64).reshape(-1, 3)
        self.ligand_idxs = np.asarray(self.ligand_idxs, dtype=np.int64)
        self.params = np.asarray(self.params)
        self.num_waters = len(self.water_idxs)
        self.kT = BOLTZ * self.temperature

    def init_state(self, device, dtype, shape=()) -> TIBDState:
        """The state of one system, or of a batch of `shape` systems (one generator)."""
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed)
        zero = torch.zeros(shape, dtype=torch.int32, device=device)
        params = torch.as_tensor(self.params, device=device, dtype=dtype).expand(*shape, -1, -1).clone()
        return TIBDState(zero, zero, params, gen)

    def set_params(self, params):
        """The parameters of states made from now on."""
        self.params = np.asarray(params)

    def reseeded(self, integrator_seed: int) -> "TIBDExchangeMove":
        """This mover with the seed get_context gives a state of that integrator seed."""
        return replace(self, seed=water_sampler_seed(integrator_seed))

    @staticmethod
    def n_proposed(state: TIBDState) -> int:
        return int(state.n_proposed.sum())

    @staticmethod
    def n_accepted(state: TIBDState) -> int:
        return int(state.n_accepted.sum())

    def draw(self, generator, k: int, device):
        """A firing's float64 draws for k systems: uniforms (P, k, 198 + W) and normals (P, k, 7)."""
        shape = (self.n_proposals, k)
        uniforms = torch.rand((*shape, _U_GUMBEL + self.num_waters), generator=generator, device=device, dtype=FIRING_DTYPE)
        normals = torch.randn((*shape, _N_NORMAL), generator=generator, device=device, dtype=FIRING_DTYPE)
        return uniforms, normals

    def make_move_fn(self, energy_fn=None, device=None):
        """move(state, x, v, box, with_trace=False) -> (state, x, v, box[,
        trace]), its draws from state.generator; move_with_draws the same
        given them. energy_fn is unused: the sampler has parameters of its
        own (the Context's energy is not the sampler's). The trace holds,
        per proposal and system, JAX's record (chosen, i2o, site, rot,
        raw_log_p, log_u, accept, n1), and the weights the firing carried
        to its end ("weights")."""
        del energy_fn
        firing = _Firing(self, device)

        def move_with_draws(state, x, v, box, uniforms, normals, with_trace=False):
            single = x.dim() == 2
            xs, boxes, params = (x[None], box[None], state.params[None]) if single else (x, box, state.params)
            xs, n_acc, trace = firing.run(params, xs, boxes, uniforms, normals, with_trace)
            if single:
                xs, n_acc = xs[0], n_acc[0]
            new_state = replace(state, n_accepted=state.n_accepted + n_acc, n_proposed=state.n_proposed + self.n_proposals)
            return (new_state, xs, v, box, trace) if with_trace else (new_state, xs, v, box)

        def move(state, x, v, box, with_trace=False):
            k = 1 if x.dim() == 2 else x.shape[0]
            uniforms, normals = self.draw(state.generator, k, x.device)
            return move_with_draws(state, x, v, box, uniforms, normals, with_trace)

        move.with_draws = move_with_draws
        move.firing = firing
        return move


class _Firing:
    """One mover's constants on a device and its proposal steps over K systems."""

    def __init__(self, mover: TIBDExchangeMove, device):
        self.mover = mover
        self.weights = WaterWeights(mover.water_idxs, mover.beta, mover.cutoff, mover.kT, mover.n_atoms, device=device)
        self.water_idxs = self.weights.water_idxs
        self.ligand_idxs = torch.as_tensor(mover.ligand_idxs, device=self.water_idxs.device)
        self.radius = float(mover.radius)
        self.vol_sphere = (4.0 / 3.0) * math.pi * self.radius**3

    def region(self, xs, center, box_diag):
        """(inner (K, W) bool, n1 (K,)): waters whose centroid lies within the radius of center."""
        centroids = torch.mean(xs[:, self.water_idxs], dim=2)
        dij = torch.linalg.vector_norm(_delta_r(centroids, center[:, None], box_diag[:, None]), dim=-1)
        inner = dij < self.radius
        return inner, torch.sum(inner, dim=-1)

    def sites(self, center, box_diag, uniforms, normals):
        """(P, K, 3) insertion sites inside the sphere and outside it."""
        xyz = normals[..., :3]
        xyz = xyz / torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
        site_in = xyz * (uniforms[..., _U_SPHERE, None] ** (1.0 / 3.0) * self.radius) + center
        tries = uniforms[..., _U_OUTER:_U_GUMBEL].unflatten(-1, (OUTER_TRIES, 3)) * box_diag[:, None]
        inside = torch.linalg.vector_norm(_delta_r(tries, center[:, None], box_diag[:, None]), dim=-1) < self.radius
        order = torch.arange(OUTER_TRIES, device=tries.device)
        first = torch.clamp(torch.amin(torch.where(inside, OUTER_TRIES, order), dim=-1), max=OUTER_TRIES - 1)
        site_out = torch.take_along_dim(tries, first[..., None, None], dim=-2)[..., 0, :]
        return site_in, site_out

    def proposal(self, params, xs, boxes, weights, i2o, chosen, site, rot, log_u, inner, n1, follow=None):
        """One proposal of every system given its decisions (JAX's record):
        (x, weights, accept, raw_log_p) after it; x and the weights move as
        `follow` (K,) bool says where given, else as accept."""
        W = self.weights.num_waters
        box_diag = torch.diagonal(boxes, dim1=-2, dim2=-1)
        vi = torch.where(i2o[:, None], inner, ~inner)
        chosen = chosen.long()
        a_idxs = self.water_idxs[chosen]
        old_pos = torch.take_along_dim(xs, a_idxs[..., None], dim=1)
        new_pos = (old_pos - torch.mean(old_pos, dim=1, keepdim=True)) @ rot.transpose(-1, -2) + site[:, None]
        after = self.weights.moved(params, xs, boxes, chosen, new_pos, weights)

        is_chosen = torch.arange(W, device=xs.device) == chosen[:, None]
        lse_before = torch.logsumexp(torch.where(vi, weights, -torch.inf), dim=-1)
        lse_after = torch.logsumexp(torch.where(~vi | is_chosen, after, -torch.inf), dim=-1)
        vol_box = torch.prod(box_diag, dim=-1)
        vol_i = torch.where(i2o, self.vol_sphere, vol_box - self.vol_sphere)
        vol_j = torch.where(i2o, vol_box - self.vol_sphere, self.vol_sphere)
        n_i = torch.where(i2o, n1, W - n1)
        n_j = W - n_i
        g_fwd = torch.where((n_i > 0) & (n_j > 0), 0.5, 1.0).to(xs.dtype)
        g_rev = torch.where((n_i - 1 > 0) & (n_j + 1 > 0), 0.5, 1.0).to(xs.dtype)
        raw_log_p = lse_before - lse_after + torch.log(vol_j / vol_i) + torch.log(g_rev / g_fwd)
        accept = (log_u < torch.clamp(raw_log_p, max=0.0)) & (n_i > 0)

        moved = accept if follow is None else follow
        xs = self.weights.place(xs, chosen, torch.where(moved[:, None, None], new_pos, old_pos))
        weights = torch.where(moved[:, None], after, weights)
        return xs, weights, accept, raw_log_p

    def run(self, params, xs, boxes, uniforms, normals, with_trace=False):
        """A firing of K systems, computed in FIRING_DTYPE: (x in its own dtype,
        accepted (K,) int32, trace or None)."""
        dtype = xs.dtype
        params, xs, boxes, uniforms, normals = (t.to(FIRING_DTYPE) for t in (params, xs, boxes, uniforms, normals))
        box_diag = torch.diagonal(boxes, dim1=-2, dim2=-1)
        center = torch.mean(xs[:, self.ligand_idxs], dim=1)  # the ligand does not move in a firing
        weights = self.weights.full(params, xs, boxes)
        site_in, site_out = self.sites(center, box_diag, uniforms, normals)
        q = normals[..., 3:]
        rots = quaternion_to_rotation(q / torch.linalg.vector_norm(q, dim=-1, keepdim=True))
        gumbel = -torch.log(-torch.log(uniforms[..., _U_GUMBEL:]))
        log_us = torch.log(uniforms[..., _U_ACC])
        n_acc = torch.zeros(xs.shape[0], dtype=torch.int32, device=xs.device)
        records = []
        for p in range(uniforms.shape[0]):
            inner, n1 = self.region(xs, center, box_diag)
            p_i2o = torch.where(n1 == 0, 0.0, torch.where(n1 == self.weights.num_waters, 1.0, 0.5)).to(FIRING_DTYPE)
            i2o = uniforms[p, :, _U_DIR] < p_i2o
            vi = torch.where(i2o[:, None], inner, ~inner)
            chosen = torch.argmax(torch.where(vi, weights + gumbel[p], -torch.inf), dim=-1)
            site = torch.where(i2o[:, None], site_out[p], site_in[p])
            xs, weights, accept, raw_log_p = self.proposal(
                params, xs, boxes, weights, i2o, chosen, site, rots[p], log_us[p], inner, n1
            )
            n_acc = n_acc + accept.to(torch.int32)
            if with_trace:
                records.append(dict(chosen=chosen, i2o=i2o, site=site, rot=rots[p], raw_log_p=raw_log_p,
                                    log_u=log_us[p], accept=accept, n1=n1))
        trace = None
        if with_trace:
            trace = {key: torch.stack([r[key] for r in records]) for key in records[0]}
            trace["weights"] = weights
        return xs.to(dtype), n_acc, trace

    def replay(self, params, xs, boxes, records, follow_accepts: bool = False):
        """The proposals of a firing given its records (chosen, i2o, site,
        rot, log_u, and with follow_accepts the recorded accept; leading
        axis the proposals, then K): the region from the current x, the
        rest as recorded, x and the weights moving as this replay decides
        or, with follow_accepts, as the record did. Returns (x, raw_log_p
        (P, K), accept (P, K), n1 (P, K), the weights at the end), in
        FIRING_DTYPE."""
        params, xs, boxes = (t.to(FIRING_DTYPE) for t in (params, xs, boxes))
        records = {k: v.to(FIRING_DTYPE) if v.is_floating_point() else v for k, v in records.items()}
        box_diag = torch.diagonal(boxes, dim1=-2, dim2=-1)
        center = torch.mean(xs[:, self.ligand_idxs], dim=1)
        weights = self.weights.full(params, xs, boxes)
        raws, accepts, n1s = [], [], []
        for p in range(records["chosen"].shape[0]):
            inner, n1 = self.region(xs, center, box_diag)
            xs, weights, accept, raw = self.proposal(
                params, xs, boxes, weights, records["i2o"][p], records["chosen"][p], records["site"][p],
                records["rot"][p], records["log_u"][p], inner, n1, records["accept"][p] if follow_accepts else None,
            )
            raws.append(raw)
            accepts.append(accept)
            n1s.append(n1)
        return xs, torch.stack(raws), torch.stack(accepts), torch.stack(n1s), weights


def _delta_r(ri, rj, box_diag):
    diff = ri - rj
    return diff - box_diag * torch.floor(diff / box_diag + 0.5)
