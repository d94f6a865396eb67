"""The port's micro-probes (``tpu_raytracing_torch/benchmarks/``) against the
JAX scripts in ``benchmarks/`` on the CPU.

Each case loads a reference script by path (``benchmarks/`` has no
``__init__.py``), runs its own Pallas kernel in interpret mode at a small
size (N = 64 loop iterations, ITERS = 8 lane iterations), and feeds the
same arrays, as numpy, to the port's plain version. Equality is exact on
every output: the outputs are int32 sums, float32 copies (the gathers),
integer-valued float32 (the chains, E2's one-hot product) or float32
arithmetic in the reference's order. Scratch the reference reads before
writing holds what interpret mode leaves there (NaN / INT32_MIN, pinned by
``test_interpret_scratch_fill``), and the port is handed the same.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tpu_raytracing_torch.benchmarks import _common, _lane, _micro  # noqa: E402
from tpu_raytracing_torch.benchmarks import (  # noqa: E402
    micro_control,
    micro_pallas,
    probe_lane_machine,
    probe_lane_machine2,
    probe_lane_machine3,
)

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
N_SMALL = 64
ITERS_SMALL = 8
_PALLAS_CALL = pl.pallas_call


def load_reference(name):
    spec = importlib.util.spec_from_file_location(f"_reference_{name}",
                                                  REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class PallasRecorder:
    """Stands in for ``pl.pallas_call``: keeps each call's kernel and
    keyword arguments and returns a function that gives zeros of the output
    shape, so a script's ``main`` runs through without computing."""

    def __init__(self):
        self.calls = []

    def __call__(self, kernel, **kw):
        self.calls.append((kernel, kw))
        shape = kw["out_shape"]
        return lambda *args: jnp.zeros(shape.shape, shape.dtype)


def record_main(mod):
    rec = PallasRecorder()
    orig = pl.pallas_call
    pl.pallas_call = rec
    try:
        mod.main()
    finally:
        pl.pallas_call = orig
    return rec.calls


def interpret(kernel, kw):
    return jax.jit(lambda *args: pl.pallas_call(kernel, interpret=True, **kw)(*args))


# ------------------------------------------------------------ scratch fill

def test_interpret_scratch_fill():
    """Interpret mode fills scratch that a kernel reads before writing with
    NaN (float32) and INT32_MIN (int32); the port's interpret_fill says the
    same. A JAX upgrade that changes this fails here, not silently in the
    probes' reference values."""
    def kern(x_ref, f_out, i_out, fv, iv, fs):
        f_out[...] = fv[...] + fs[0] * 0.0 + x_ref[...] * 0.0
        i_out[...] = iv[...]

    f, i = pl.pallas_call(
        kern, interpret=True,
        out_shape=(jax.ShapeDtypeStruct((8, 128), jnp.float32),
                   jax.ShapeDtypeStruct((8, 128), jnp.int32)),
        scratch_shapes=[pltpu.VMEM((8, 128), jnp.float32), pltpu.VMEM((8, 128), jnp.int32),
                        pltpu.SMEM((4,), jnp.float32)],
    )(jnp.ones((8, 128), jnp.float32))
    np.testing.assert_array_equal(np.isnan(np.asarray(f)), True)
    np.testing.assert_array_equal(np.asarray(i), np.iinfo(np.int32).min)
    assert torch.isnan(_common.interpret_fill((2,), torch.float32)).all()
    assert (_common.interpret_fill((2,), torch.int32) == _common.INT32_MIN).all()


def test_f2i_is_xla_conversion():
    """The plain versions' float32 -> int32 conversion is XLA's: toward
    zero, saturating, NaN -> 0."""
    x = np.array([np.nan, -np.nan, np.inf, -np.inf, 3e9, -3e9, 2147483520.0, -2.7, 2.7, -0.0,
                  0.49, -2147483648.0], np.float32)
    ref = np.asarray(jax.jit(lambda a: a.astype(jnp.int32))(x))
    np.testing.assert_array_equal(_common.f2i(torch.from_numpy(x)).numpy(), ref)


def test_int32_helpers_match_jax():
    """idx_of wraps as JAX's int32 arithmetic does; remainder is
    jnp.remainder."""
    i = np.arange(0, 200_000, 997, dtype=np.int32)
    for seed in (0, 3, 2**31 - 1, -(2**31), -12345):
        ref = ((jnp.asarray(i) * 7919 + jnp.int32(seed)) * 1103515245 & 0x7FFFFFFF) % 65536
        got = _common.idx_of(torch.from_numpy(i), seed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    x = np.random.default_rng(0).normal(0, 300, 256).astype(np.float32)
    for y in (127.0, -7.5):
        np.testing.assert_array_equal(_common.remainder(torch.from_numpy(x), y).numpy(),
                                      np.asarray(jnp.remainder(jnp.asarray(x), y)))


# ------------------------------------------------------------ scalar loops

@pytest.fixture(scope="module")
def scalar_refs():
    """{kind: (module, kernel, pallas_call kwargs)} for both scalar scripts."""
    out = {}
    for name, port in (("micro_pallas", micro_pallas), ("micro_control", micro_control)):
        mod = load_reference(name)
        calls = record_main(mod)
        assert len(calls) == len(port.KINDS)
        for kind, (kernel, kw) in zip(port.KINDS, calls):
            out[kind] = (mod, kernel, kw)
    return out


@pytest.mark.parametrize("seed", [3])
@pytest.mark.parametrize("kind", micro_pallas.KINDS + micro_control.KINDS)
def test_scalar_probe_matches_reference(scalar_refs, monkeypatch, kind, seed):
    mod, kernel, kw = scalar_refs[kind]
    monkeypatch.setattr(mod, "N", N_SMALL)
    rows = np.arange(65536 * 128, dtype=np.int32).reshape(65536, 128)
    ref = np.asarray(interpret(kernel, kw)(jnp.asarray(rows), jnp.full((1,), seed, jnp.int32)))
    port = micro_pallas if kind in micro_pallas.KINDS else micro_control
    before = dict(port.launch_count)
    got = port.probe(kind, torch.from_numpy(rows), torch.tensor([seed], dtype=torch.int32),
                     N_SMALL)
    out = got[0] if isinstance(got, tuple) else got
    np.testing.assert_array_equal(out.numpy(), ref)
    assert port.launch_count == before  # CPU tensors take the plain version


def test_comp_tile_is_reference_arithmetic():
    """comp's tile, which the reference keeps only in scratch: the port's
    plain version against the same operations in numpy float32, rounded
    after each one as the kernel computes them (-fmad=false), from a finite
    start. (XLA's CPU compiler contracts x * 1.0001 + 0.5 into one fused
    multiply-add, so jnp on the CPU is not this reference.)"""
    acc = np.random.default_rng(1).normal(size=(8, 128)).astype(np.float32)
    x = acc.copy()
    f = np.float32
    for _ in range(5):
        for _ in range(6):
            x = np.maximum(x * f(1.0001) + f(0.5), x)
            x = np.minimum(x * f(0.9999) - f(0.5), x)
        for _ in range(6):
            x = x + np.minimum(x, f(0.25) * x)
    fill = dict(_micro.interpret_fills(), acc=torch.from_numpy(acc))
    rows = _micro.make_rows("cpu")
    _, tile = micro_pallas.probe("comp", rows, torch.tensor([1], dtype=torch.int32), 5, fill)
    np.testing.assert_array_equal(tile.numpy(), x)


@pytest.mark.parametrize("kind", micro_control.KINDS)
def test_control_probe_with_seeded_scratch(scalar_refs, monkeypatch, kind):
    """The same probes from seeded scratch in place of interpret mode's
    fill: the reference's kernel with its scratch preset by a wrapper
    kernel is beyond interpret mode, so the port's closed forms are held to
    a literal per-iteration walk of the reference's body in Python ints."""
    fill = _micro.make_fill(7, "cpu")
    rows = _micro.make_rows("cpu")
    got = micro_control.probe(kind, rows, torch.tensor([5], dtype=torch.int32), 40, fill)
    assert int(got[0]) == _literal_control(kind, 5, 40, fill)


def _literal_control(kind, seed, n, fill):
    """micro_control's kernel bodies, iteration by iteration, in Python ints
    wrapped to int32 (the stack words only where they reach the output)."""
    def w(x):
        return (x + 2**31) % 2**32 - 2**31

    vec = fill["vec"].numpy()
    meta = fill["meta"].numpy().astype(np.int64)
    spp = [int(v) for v in fill["spp"].numpy()]

    def ints(v, i):
        return [int(_common.f2i(torch.tensor([x * np.float32(i % 7 + 1)],
                                             dtype=torch.float32))[0]) for x in v]

    def push(sp, vmask, emin):
        for e in range(8):
            ok = ((vmask >> e) & 1) == 1 and e != emin
            sp = w(sp + int(ok))
        return sp

    s = 0
    if kind in ("red1", "red2"):
        for i in range(n):
            x = ints(vec[:8], i)
            for r in range(int(kind[-1])):
                s = w(s + min(w(v + r) for v in x))
    elif kind in ("when4", "when12"):
        scr = spp[:16]
        for i in range(n):
            for k in range(int(kind[4:])):
                if (i + k) % 3 != 0:
                    scr[k] = w(scr[k] + i)
            s = w(s + scr[0])
    elif kind == "push8":
        for i in range(n):
            sp = push(spp[0], i & 0xFF, i % 8)
            spp[0] = sp % 200
            s = w(s + sp)
    elif kind == "read8":
        for _ in range(n):
            for e in range(8):
                s = w(s + int(meta[e * 8 + 6]))
    elif kind == "combo":
        for i in range(n):
            x = ints(vec[:8], i)
            sp = push(spp[0], sum(v & 1 for v in x), min(x) % 8)
            spp[0] = sp % 200
            s = w(s + sp)
    elif kind == "batch4":
        for i in range(n // 4):
            packed = min(w(v + k) for k, v in enumerate(ints(vec, i)))
            for c in range(4):
                sp = push(spp[0], (packed >> (c * 8)) & 0xFF, packed % 8)
                spp[0] = sp % 200
            s = w(s + spp[0])
    return s


# ------------------------------------------------------------ lane machine

class InterpretRecorder:
    """Stands in for ``pl.pallas_call``: runs the kernel in interpret mode
    and keeps the numpy inputs and output of every call made on concrete
    arrays (the scripts' one-shot correctness calls)."""

    def __init__(self, orig):
        self.orig = orig
        self.calls = []

    def __call__(self, kernel, **kw):
        fn = self.orig(kernel, interpret=True, **kw)

        def call(*args):
            out = fn(*args)
            if not any(isinstance(a, jax.core.Tracer) for a in args):
                self.calls.append(([np.asarray(a) for a in args], np.asarray(out)))
            return out
        return call


def run_lane_script(name, monkeypatch, body):
    """``body(mod)`` with the script's ITERS at 8, pallas_call in interpret
    mode and ``timeit`` running a function once: returns (one-shot calls,
    timed calls), each a list of (numpy inputs, numpy output)."""
    mod = load_reference(name)
    monkeypatch.setattr(mod, "ITERS", ITERS_SMALL)
    rec = InterpretRecorder(_PALLAS_CALL)
    monkeypatch.setattr(pl, "pallas_call", rec)
    timed = []

    def timeit(fn, *args, reps=1):
        out = fn(*args)
        timed.append(([np.asarray(a) for a in args], np.asarray(out)))
        return 1.0

    monkeypatch.setattr(mod, "timeit", timeit)
    body(mod)
    return rec.calls, timed


@pytest.fixture(scope="module")
def lane_refs():
    """{(module, kind): (numpy inputs, numpy output)} from the three scripts
    run in interpret mode."""
    mp = pytest.MonkeyPatch()
    refs = {}
    try:
        def plm1(mod):
            for fn in (mod.e1_lane_gather, mod.e1b_tall_gather, mod.e1c_timing,
                       mod.e2_onehot_matmul, mod.e3_stack_shift, mod.e4_sublane_gather,
                       mod.e5_full_body_mock):
                fn()
        once, timed = run_lane_script("probe_lane_machine", mp, plm1)
        for kind, call in zip(("e1", "e1b", "e3_once", "e4"), once):
            refs[(probe_lane_machine, kind)] = call
        for kind, call in zip(("e1c", "e2", "e3", "e5"), timed):
            refs[(probe_lane_machine, kind)] = call

        def plm2(mod):
            for kind in probe_lane_machine2.BODIES:
                f, tab, idx0 = mod.make(kind)
                refs[(probe_lane_machine2, kind)] = (
                    [np.asarray(tab), np.asarray(idx0)], np.asarray(f(tab, idx0)))
            for lanes in (256, 512):
                mod.wide_gather_check(lanes)
        once, _ = run_lane_script("probe_lane_machine2", mp, plm2)
        for kind, call in zip(("wide256", "wide512"), once):
            refs[(probe_lane_machine2, kind)] = call

        def plm3(mod):
            for kind in probe_lane_machine3.KINDS:
                f, tab, idx0, _ = mod.make(kind)
                refs[(probe_lane_machine3, kind)] = (
                    [np.asarray(tab), np.asarray(idx0)], np.asarray(f(tab, idx0)))
        run_lane_script("probe_lane_machine3", mp, plm3)
    finally:
        mp.undo()
    return refs


def _torch_of(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


LANE_CASES = ([(probe_lane_machine, k) for k in probe_lane_machine.KINDS]
              + [(probe_lane_machine2, k) for k in probe_lane_machine2.KINDS]
              + [(probe_lane_machine3, k) for k in probe_lane_machine3.KINDS])


@pytest.mark.parametrize("port,kind", LANE_CASES,
                         ids=[f"{p.__name__.rsplit('.', 1)[1]}-{k}" for p, k in LANE_CASES])
def test_lane_probe_matches_reference(lane_refs, port, kind):
    args, ref = lane_refs[(port, kind)]
    before = dict(port.launch_count)
    out, _ = port.probe(kind, *(_torch_of(a) for a in args), ITERS_SMALL)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert port.launch_count == before  # CPU tensors take the plain version


@pytest.mark.parametrize("port,kind", [(probe_lane_machine, k) for k in ("e1", "e1b", "e3_once",
                                                                         "e4")]
                         + [(probe_lane_machine2, k) for k in ("wide256", "wide512")])
def test_lane_gathers_match_library(port, kind):
    """The one-shot gathers against the PyTorch call chip_smoke.py times
    beside them (take_along_dim), on the port's own seeded inputs."""
    tab, idx = port.inputs(kind, 11, "cpu")
    out, _ = port.probe(kind, tab, idx, ITERS_SMALL)
    assert torch.equal(out, port.library(kind, tab, idx))


def test_e2_plain_chain_matches_library():
    """E2's plain chain against PyTorch's own (the library chain timed
    beside E2): torch.matmul one-hot products and remainder, step by step."""
    tab, idx = probe_lane_machine.inputs("e2", 5, "cpu")
    out, _ = probe_lane_machine.probe("e2", tab, idx, 3)
    assert torch.equal(out, probe_lane_machine.library("e2", tab, idx, 3))


def test_bank_profile():
    """Distinct columns per warp read and the conflict degree: broadcasts,
    a conflict-free spread, four columns to a bank, and a warp on two
    columns of one bank."""
    lanes = torch.arange(128)
    two = torch.where(lanes % 2 == 0, 0, 32)
    for ptrs, want in ((torch.zeros(128), (1.0, 1.0)), (lanes, (32.0, 1.0)),
                       (4 * (lanes % 32) + lanes // 32, (32.0, 4.0)), (two, (2.0, 2.0))):
        assert _lane.bank_profile(ptrs[None, :].long()) == want


@pytest.mark.parametrize("spread", list(probe_lane_machine2.SPREADS))
def test_spread_inputs_keep_their_layout(spread):
    """fetch on spread_inputs: the plain chain's columns are pointer_walk's
    at every step, and keep the spread's distinct columns and conflict
    degree."""
    tab, idx = probe_lane_machine2.spread_inputs(spread, 2, "cpu")
    walk = _lane.pointer_walk(tab, idx[0], ITERS_SMALL + 1)
    for n in range(1, ITERS_SMALL + 1):
        out, _ = probe_lane_machine2.probe("fetch", tab, idx, n)
        assert torch.equal(_lane.lane_ptr(out[0]), walk[n])
    cols, degree = _lane.bank_profile(walk)
    assert (cols, degree) == {"same": (1.0, 1.0), "distinct": (32.0, 1.0),
                              "distinct4": (32.0, 4.0)}[spread]


def test_pointer_walk_relative_is_the_v_chain():
    """pointer_walk(relative=True) follows the V kernels' state: V1's row 0
    after n steps."""
    tab, idx = probe_lane_machine3.inputs("V1", 4, "cpu")
    walk = _lane.pointer_walk(tab, idx[0], 6, relative=True)
    out, _ = probe_lane_machine3.probe("V1", tab, idx, 5)
    assert torch.equal(out[0].long(), walk[5])


def test_entry_points_refuse_missing_card(monkeypatch):
    """Asked for the card where there is none, every entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (micro_pallas, micro_control, probe_lane_machine, probe_lane_machine2,
                probe_lane_machine3):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])


@pytest.mark.parametrize("mod", [micro_pallas, micro_control, probe_lane_machine,
                                 probe_lane_machine2, probe_lane_machine3],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_entry_point_runs_plain_on_cpu(monkeypatch, mod):
    """--device cpu runs the plain versions at the size in N / ITERS, times
    every kind, launches nothing, and every output held to PyTorch's own
    calls agrees."""
    monkeypatch.setenv("N", "16")
    monkeypatch.setenv("ITERS", "2")
    res = mod.main(["--device", "cpu"])
    assert list(res) == list(mod.KINDS)
    assert all(v["ms"] > 0 and len(v["runs"]) == _common.REPS for v in res.values())
    assert all(v["ok"] is not False for v in res.values())
    assert mod.launch_count == {k: 0 for k in mod.KINDS}
