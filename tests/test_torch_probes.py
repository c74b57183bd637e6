"""timemachine_torch probes against the TPU scripts' op sequences: the FP32
FMA chains of scripts/probe_mfu.py and the distance-and-gate sequence of
scripts/probe_bf16.py.

Both TPU kernels are closures inside functions that need a TPU, so their
op sequences are copied here and evaluated with jnp on the CPU, at small
shapes. XLA:CPU evaluates `a * b + c` with one rounding, as fmaf does, and
the f32 gate sequence one rounding per operation, so both f32 plain
versions match bit for bit. In bf16, XLA:CPU keeps a fused chain of bf16
operations in f32 and rounds where it materializes, while the probe (like
its CUDA kernel) rounds every operation to bf16; an r^2 within a bf16
rounding of the 1.44 gate then lands on either side, so the hit counts
differ on a few elements (measured 0.27% of elements, totals 0.08% apart):
held at 1% of elements and 0.5% of the total. The bf16 plain version is
held bit for bit against a numpy emulation that rounds each operation.

The redesigned kernel gates bf16 in packed bf16 against
`gate_threshold_bf16`; its equivalence with the f32 gate is checked here on
every bf16 value. The tile census (`probes/tile_census.py`) is held against
scripts/probe_bf16.py --census and scripts/probe_slots.py's helpers, run as
they are (JAX on the CPU), exactly.
"""

import importlib
import re
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timemachine_torch.ops import nonbonded_kernel as nbk
from timemachine_torch.probes import bf16_rate as br
from timemachine_torch.probes import fp32_peak as fp
from timemachine_torch.probes import tile_census as tc
from timemachine_torch.testsystems.dhfr import setup_dhfr_native

torch.set_num_threads(1)  # the suite's workers share the host's cores


def _exact_fma(a, b, c) -> np.float32:
    """a * b + c in exact rational arithmetic, rounded to f32 to nearest, ties to even."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(v))
    cands = (np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf)))
    return min(cands, key=lambda q: (abs(Fraction(float(q)) - v), int(np.float32(q).view(np.int32)) & 1))


def test_fma_f32_rounds_once():
    """fma_f32 equals exact rounding on random triples and on products that
    land exactly halfway between two f32 values, nudged either way by a c
    far below f64's resolution there (where the f64 sum alone rounds
    wrong)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-2, 2, 2000).astype(np.float32)
    b = rng.uniform(-2, 2, 2000).astype(np.float32)
    c = float(np.float32(1e-7))
    got = fp.fma_f32(torch.tensor(a), torch.tensor(b), c).numpy()
    np.testing.assert_array_equal(got, [_exact_fma(x, y, c) for x, y in zip(a, b)])
    half = torch.tensor([1 + 2**-12], dtype=torch.float32)  # half * half = 1 + 2^-11 + 2^-24: a midpoint
    for c in (2.0**-60, -(2.0**-60), 0.0):
        assert float(fp.fma_f32(half, half, c)) == _exact_fma(half.item(), half.item(), c)


def _script_fma_chains(x, inner):
    """scripts/probe_mfu.py::measure_vpu_peak's kernel body, in jnp."""
    a0 = x
    a1 = a0 * 1.0000001
    a2 = a0 * 1.0000002
    a3 = a0 * 1.0000003
    for _ in range(inner):
        t0 = a0 * a1 + 1e-7
        t1 = a1 * a2 + 1e-7
        t2 = a2 * a3 + 1e-7
        t3 = a3 * a0 + 1e-7
        a0, a1, a2, a3 = t0, t1, t2, t3
    return a0 + a1 + a2 + a3


@pytest.mark.parametrize("inner", [1, 5, 64])
def test_fp32_peak_plain_matches_the_script(inner):
    """Bit for bit, on (16, 128) inputs, in the transient (1 and 5 steps)
    and at the chains' fixed point (64)."""
    x = fp.inputs("cpu", shape=(16, 128))
    before = fp.fp32_peak_plain.calls
    out = fp.fp32_peak(x, inner)
    assert fp.fp32_peak_plain.calls == before + 1 and fp.fp32_peak.launches == 0
    ref = jax.jit(_script_fma_chains, static_argnums=1)(jnp.asarray(x.numpy()), inner)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert fp.flops(x.numel(), inner) == 8 * inner * x.numel()


def _script_gate(a, b, dtype, iters):
    """scripts/probe_bf16.py::probe_rate's kernel body, in jnp."""
    a = a.astype(dtype)
    b = b.astype(dtype)
    acc = jnp.zeros(a.shape, dtype)

    def body(t, acc):
        sh = (1.0 + t.astype(jnp.float32) * 1e-3).astype(dtype)
        dx = a - b * sh
        dy = a * sh - b
        dz = a - b
        r2 = dx * dx + dy * dy + dz * dz
        return acc + (r2.astype(jnp.float32) < 1.44).astype(dtype)

    return jax.lax.fori_loop(0, iters, body, acc).astype(jnp.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_rate_plain_matches_the_script(dtype):
    a, b = br.inputs("cpu", shape=(64, 128))
    out = br.bf16_rate(a, b, getattr(torch, dtype)).numpy()
    ref = np.asarray(jax.jit(_script_gate, static_argnums=(2, 3))(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), getattr(jnp, dtype), br.ITERS))
    assert out.min() >= 0 and out.max() <= br.ITERS and out.sum() > 0.1 * out.size * br.ITERS
    if dtype == "float32":
        np.testing.assert_array_equal(out, ref)
    else:
        assert np.mean(out != ref) < 0.01
        assert abs(out.sum() - ref.sum()) < 0.005 * ref.sum()


def _bf16(x):
    """f32 array rounded to bf16 (nearest, ties to even), kept in f32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return (((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16).astype(np.uint32).view(np.float32)


def test_bf16_plain_rounds_every_operation():
    """The bf16 plain version against numpy f32 arithmetic rounded to bf16
    after every operation (exact here: a product or difference of these
    bf16 values is exact in f32 before its one rounding), bit for bit."""
    a, b = br.inputs("cpu", shape=(32, 64))
    av, bv = _bf16(a.numpy()), _bf16(b.numpy())
    acc = np.zeros_like(av)
    for t in range(br.ITERS):
        sh = _bf16(np.float32(1.0) + np.float32(t) * np.float32(1e-3))
        dx = _bf16(av - _bf16(bv * sh))
        dy = _bf16(_bf16(av * sh) - bv)
        dz = _bf16(av - bv)
        r2 = _bf16(_bf16(_bf16(dx * dx) + _bf16(dy * dy)) + _bf16(dz * dz))
        acc = _bf16(acc + (r2 < np.float32(br.CUT2)).astype(np.float32))
    np.testing.assert_array_equal(br.bf16_rate_plain(a, b, torch.bfloat16).numpy(), acc)


# -- the redesigned gate and the tile census -------------------------------------------

REPO = Path(__file__).resolve().parents[1]


def _all_bf16():
    """Every bf16 value, by its 65,536 bit patterns: +-0, subnormals, +-inf, NaNs."""
    return torch.arange(2**16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)


@pytest.mark.parametrize("cut2", [br.CUT2, 1.5, -1.44, 0.0, 1e-40, 3.4e38, float("inf")])
def test_bf16_threshold_gate_is_the_f32_gate(cut2):
    """f32(x) < cut2 (the plain version's gate) equals x < T in bf16 for
    every bf16 x, T = gate_threshold_bf16(cut2): at the probe's 1.44, at a
    cut2 that is a bf16 value itself (1.5: the strict < stays strict), and
    at a negative, zero, subnormal, huge and infinite cut2."""
    x = _all_bf16()
    bits = br.gate_threshold_bf16(cut2)
    thr = torch.tensor([bits], dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    assert float(thr) >= float(np.float32(cut2))
    np.testing.assert_array_equal((x < thr).numpy(), (x.float() < cut2).numpy())
    if cut2 == br.CUT2:
        assert float(thr) == 1.4453125
    if cut2 == 1.5:
        assert float(thr) == 1.5


def test_redesign_constants_mirror_the_source():
    """ELEMS and THREADS in bf16_rate.py are csrc/probe_bf16.cu's."""
    source = (REPO / "timemachine_torch" / "csrc" / "probe_bf16.cu").read_text()
    for name in ("ELEMS", "THREADS"):
        found = re.findall(rf"constexpr int {name} = (\d+);", source)
        assert found == [str(getattr(br, name))], name


def _scripts(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    return importlib.import_module("probe_slots"), importlib.import_module("probe_bf16")


def _water_box(n_water=343, box_nm=2.18, seed=0):
    """O on a jittered lattice, two H 0.1 nm away, shifted so some atoms lie
    outside the box on every side."""
    rng = np.random.default_rng(seed)
    side = round(n_water ** (1 / 3))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    o = (grid + 0.5) * box_nm / side + rng.normal(0, 0.02, grid.shape)
    dirs = rng.normal(size=(len(o), 2, 3))
    h = o[:, None, :] + 0.1 * dirs / np.linalg.norm(dirs, axis=2, keepdims=True)
    conf = np.concatenate([o[:, None, :], h], axis=1).reshape(-1, 3) - 0.3
    return conf, np.diag([box_nm] * 3)


def test_census_helpers_match_the_script(monkeypatch):
    """tile_census's Hilbert order, chunk boxes and box gaps equal
    scripts/probe_slots.py's, exactly, on a water box whose Hilbert keys are
    unique (so the order does not depend on how ties are sorted)."""
    slots, _ = _scripts(monkeypatch)
    conf, box = _water_box()
    order_s, wrapped_s = slots.hilbert_order(conf, box)
    conf_t, box_t = torch.as_tensor(conf), torch.as_tensor(box)
    order_p, wrapped_p = tc.hilbert_order(conf_t, box_t)
    diag = torch.diagonal(box_t)
    frac = wrapped_p / diag
    assert torch.unique(nbk.hilbert_keys((frac - torch.floor(frac)).float())).numel() == len(conf)
    np.testing.assert_array_equal(order_p.numpy(), order_s)
    np.testing.assert_array_equal(wrapped_p.numpy(), wrapped_s)
    xs = wrapped_s[order_s]
    xs = np.concatenate([xs, np.tile(np.diagonal(box) / 2.0 + 100.0, (-len(xs) % tc.COL, 1))])
    boxes = {}
    for size in (tc.ROW, tc.COL):
        want, got = slots.chunk_bboxes(xs, size), tc.chunk_bboxes(torch.as_tensor(xs), size)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), w)
        boxes[size] = want
    want = slots.gap2(*boxes[tc.ROW], *boxes[tc.COL], np.diagonal(box))
    got = tc.gap2(*(torch.as_tensor(v) for v in (*boxes[tc.ROW], *boxes[tc.COL])), diag)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any() and (want > 0).any()


def test_tile_census_matches_the_script_on_dhfr(monkeypatch, capsys):
    """tile_census on the DHFR start prints, in the script's own format,
    exactly what scripts/probe_bf16.py --census prints (24,523 tiles built,
    22,889 after the chop, 7,531 with no pair within the cutoff)."""
    _, script = _scripts(monkeypatch)
    script.probe_census()
    printed = capsys.readouterr().out
    hc = setup_dhfr_native(waters_first=True, device="cpu")
    c = tc.tile_census(hc.conf, hc.box, "cpu")
    assert (c.built, c.chopped, c.empty) == (24523, 22889, 7531)
    assert printed == (
        f"n_atoms {c.n_atoms}  row_chunks {c.row_chunks}  col_chunks {c.col_chunks}\n"
        f"tiles built {c.built}  after chop {c.chopped}\n"
        f"all-empty tiles after chop: {c.empty} ({c.empty / c.chopped * 100:.2f}%)\n"
        f"swept slots {c.slots / 1e6:.1f}M  in-cutoff {c.hits / 1e6:.1f}M "
        f"(occupancy {c.hits / c.slots * 100:.1f}%)\n"
        f"prefilter skip ceiling: {c.skip_ceiling * 100:.2f}% of sweep time\n"
    )
