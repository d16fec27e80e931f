"""The route of ops/qpsolve.solve_qp between the resident QP kernel
(csrc/resident_qp.cu via ops/cuda_qp.py) and the op-by-op chain, on the
CPU.

The route is one rule on device, dtype and shape (`cuda_qp.takes`),
applied before any launch: CUDA, every field float32, n <= 30, p <= 30,
m <= 72 take the kernel; the CPU, another dtype and larger problems (the
condensed planner's n = 12H) run `_solve_qp_impl` as before.  The rule
and the wrapper's checks read only each field's device, dtype and shape,
so stand-ins with those attributes exercise them here without a card; the
kernel's numbers are held on the card (tests/test_torch_cuda.py).
"""

import re

import pytest
import torch

from apf_quadruped_tpu_torch import _kernels, problems, wbc
from apf_quadruped_tpu_torch.config import EngineConfig, SolverConfig
from apf_quadruped_tpu_torch.models import zoo
from apf_quadruped_tpu_torch.ops import cuda_qp, qpsolve
from apf_quadruped_tpu_torch.runtime import graph

SRC = _kernels.CSRC / "resident_qp.cu"
F32, F64 = torch.float32, torch.float64


class Stand:
    """A tensor's device, dtype and shape, nothing else."""

    def __init__(self, shape, dtype=F32, device="cuda"):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device(device)

    def dim(self):
        return len(self.shape)


def _stand_qp(B, n, p, m, dtype=F32, device="cuda", **over):
    """A QPData of stand-ins at batch B and sizes (n, p, m); `over` replaces
    fields (by name) with stand-ins of another dtype or shape."""
    shapes = dict(P=(B, n, n), q=(B, n), A=(B, p, n), b=(B, p), G=(B, m, n),
                  h=(B, m), eq_mask=(B, p), ineq_mask=(B, m))
    fields = {f: Stand(s, dtype, device) for f, s in shapes.items()}
    fields.update(over)
    return qpsolve.QPData(**fields)


def _wbc_qp(cfg, B=3, dtype=F32, crawl=False):
    st, ref = problems.wbc_problem(cfg, B, seed=0, dtype=dtype, device="cpu")
    if crawl:
        st = st._replace(contact=torch.tensor([1.0, 1.0, 0.0, 1.0],
                                              dtype=dtype).expand(B, 4),
                         crawl=torch.ones(B, dtype=torch.bool))
    qp, _ = wbc._build_qp(cfg, st, ref)
    return qp


def _as_stand(qp, device="cuda"):
    return qpsolve.QPData(*(Stand(v.shape, v.dtype, device) for v in qp))


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

ROUTE = {
    "WBC sizes": ((1024, 30, 30, 68), {}, True),
    "one lane": ((1, 30, 30, 68), {}, True),
    "the kernel's largest m": ((8, 30, 30, 72), {}, True),
    "smaller sizes, padded": ((8, 5, 1, 7), {}, True),
    "m past the maximum": ((8, 30, 30, 73), {}, False),
    "n past the maximum": ((8, 31, 30, 68), {}, False),
    "p past the maximum": ((8, 30, 31, 68), {}, False),
    "condensed planner, H=20": ((8, 240, 1, 480), {}, False),
    "no equality row": ((8, 30, 0, 68), {}, False),
    "float64": ((8, 30, 30, 68), {"dtype": F64}, False),
    "a float64 mask": ((8, 30, 30, 68),
                       {"eq_mask": Stand((8, 30), F64)}, False),
    "CPU tensors": ((8, 30, 30, 68), {"device": "cpu"}, False),
}


@pytest.mark.parametrize("case", list(ROUTE))
def test_route_rule_by_device_dtype_and_shape(case):
    sizes, kw, want = ROUTE[case]
    assert cuda_qp.takes(_stand_qp(*sizes, **kw)) is want


@pytest.mark.parametrize("robot,crawl", [("dogbot", False), ("dogbot", True),
                                         ("anymal", False), ("hyq", True)])
def test_every_wbc_qp_takes_the_kernel_on_the_card(robot, crawl):
    """The WBC's QP in the DogBot's and the zoo quadrupeds' configurations,
    trotting and crawling, has the kernel's shapes: in float32 on the card
    it takes the kernel; in float64, or on the CPU, the chain."""
    cfg = (EngineConfig() if robot == "dogbot"
           else zoo.engine_config_for(robot))
    qp = _wbc_qp(cfg, crawl=crawl)
    assert (qp.q.shape[-1], qp.b.shape[-1], qp.h.shape[-1]) == (30, 30, 68)
    assert cuda_qp.takes(_as_stand(qp))
    assert not cuda_qp.takes(qp)
    assert not cuda_qp.takes(_as_stand(_wbc_qp(cfg, dtype=F64)))


def test_limits_match_the_kernel_source():
    """The wrapper's limits are the constants the kernel compiles with."""
    src = SRC.read_text()
    n = int(re.search(r"constexpr int N = (\d+);", src).group(1))
    m = int(re.search(r"constexpr int M_MAX = (\d+);", src).group(1))
    assert (cuda_qp.N_MAX, cuda_qp.P_MAX, cuda_qp.M_MAX) == (n, n, m)
    assert m >= 68


# ---------------------------------------------------------------------------
# what runs where
# ---------------------------------------------------------------------------

def _spies(monkeypatch):
    calls = {"impl": 0, "kernel": 0}
    impl = qpsolve._solve_qp_impl

    def spy_impl(qp, cfg):
        calls["impl"] += 1
        return impl(qp, cfg)

    def spy_kernel(qp, cfg):
        calls["kernel"] += 1
        return tuple(torch.zeros(()) for _ in qpsolve.QPSolution._fields)

    monkeypatch.setattr(qpsolve, "_solve_qp_impl", spy_impl)
    monkeypatch.setattr(cuda_qp, "solve_qp_resident", spy_kernel)
    return calls


@pytest.mark.parametrize("dtype", [F32, F64])
def test_cpu_runs_the_chain_unchanged(monkeypatch, dtype):
    """On the CPU solve_qp and wbc.solve run _solve_qp_impl, whose answer
    is the one they return, bit for bit; the kernel is never called."""
    qp = _wbc_qp(EngineConfig(), dtype=dtype)
    cfg = SolverConfig()
    ref = qpsolve._solve_qp_impl(qp, cfg)
    calls = _spies(monkeypatch)
    sol = qpsolve.solve_qp(qp, cfg)
    assert calls == {"impl": 1, "kernel": 0}
    for a, b in zip(sol, ref):
        assert torch.equal(a, b)
    st, refs = problems.wbc_problem(EngineConfig(), 2, dtype=dtype,
                                    device="cpu")
    wbc.solve(EngineConfig(), st, refs)
    assert calls == {"impl": 2, "kernel": 0}


def test_eager_body_sends_what_the_kernel_takes_to_it(monkeypatch):
    """_solve_qp_eager hands a QP that cuda_qp.takes to the kernel's
    wrapper, whose outputs become the QPSolution, and runs no chain."""
    calls = _spies(monkeypatch)
    monkeypatch.setattr(cuda_qp, "takes", lambda qp: True)
    sol = qpsolve._solve_qp_eager(_wbc_qp(EngineConfig()), SolverConfig())
    assert calls == {"impl": 0, "kernel": 1}
    assert isinstance(sol, qpsolve.QPSolution)


def test_graph_counts_the_kernels_launches():
    """runtime/graph's counters hold the kernel's wrapper, last, so that a
    replay adds its launches and the counters' old order stands."""
    assert graph._counters()[-1] is cuda_qp.solve_qp_resident


# ---------------------------------------------------------------------------
# the wrapper's checks
# ---------------------------------------------------------------------------

REFUSED = {
    "CPU tensors": (dict(device="cpu"), ValueError, "CUDA"),
    "float64": (dict(dtype=F64), TypeError, "float32"),
    "a float64 mask": (dict(ineq_mask=Stand((4, 68), F64)), TypeError,
                       "float32"),
    "n past the limit": (dict(n=31), ValueError, "n <= 30"),
    "p past the limit": (dict(p=31), ValueError, "p <= 30"),
    "m past the limit": (dict(m=73), ValueError, "m <= 72"),
    "G of another width": (dict(G=Stand((4, 68, 29))), ValueError, "G"),
    "a mask of another length": (dict(eq_mask=Stand((4, 29))), ValueError,
                                 "eq_mask"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, case):
    """The wrapper raises before it builds or launches anything."""
    kw, err, match = REFUSED[case]
    kw = dict(kw)
    monkeypatch.setattr(_kernels, "resident_qp", lambda *a: pytest.fail(
        "the library was loaded"))
    sizes = dict(n=30, p=30, m=68)
    sizes.update({k: kw.pop(k) for k in ("n", "p", "m") if k in kw})
    opts = {k: kw.pop(k) for k in ("dtype", "device") if k in kw}
    qp = _stand_qp(4, sizes["n"], sizes["p"], sizes["m"], **opts, **kw)
    with pytest.raises(err, match=match):
        cuda_qp.solve_qp_resident(qp, SolverConfig())


def test_wrapper_refuses_a_real_cpu_qp():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_qp.solve_qp_resident(_wbc_qp(EngineConfig()), SolverConfig())


# ---------------------------------------------------------------------------
# the kernel's name and its argument block
# ---------------------------------------------------------------------------

def _kernel_names():
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+)\s*\(", SRC.read_text())


def test_kernel_name_is_counted_by_the_benchmark():
    """The benchmark counts the port's own kernels by name: the QP kernel
    falls under portbench.trace.OWN (the resident interior-point family),
    as a profiler names it, and not under the SPD kernels' pattern, which
    portbench/counts/spd_chol.py looks up by (kernel, width)."""
    from portbench import trace
    names = _kernel_names()
    assert names == ["resident_ipm_qp_kernel"]
    for shown in (f"void (anonymous namespace)::{names[0]}(QpArgs)",
                  f"(anonymous namespace)::{names[0]}((anonymous "
                  f"namespace)::QpArgs)"):
        assert trace.OWN.search(shown)
        assert not re.search(r"spd_\w+_kernel<", shown)
        assert not trace._TEMPLATE.search(shown)


def test_argument_block_mirrors_the_kernel():
    """_kernels.QpArgs lists struct QpArgs's fields in its order and
    types."""
    body = re.search(r"struct QpArgs \{(.*?)\};", SRC.read_text(),
                     re.S).group(1)
    fields = []
    for decl in body.split(";"):
        decl = re.sub(r"//[^\n]*", "", decl).strip()
        if not decl:
            continue
        kind = ("ptr" if "*" in decl else "int" if decl.startswith("int")
                else "float")
        names = re.sub(r"^(const\s+)?(float|int|uint8_t)\s*", "", decl)
        fields += [(name.replace("*", "").strip(), kind)
                   for name in names.split(",")]
    ctypes_kind = {"c_void_p": "ptr", "c_int": "int", "c_float": "float"}
    mirror = [(f, ctypes_kind[t.__name__]) for f, t in
              _kernels.QpArgs._fields_]
    assert mirror == fields

