"""The port's boundaries: no JAX inside it, no hidden fallbacks.

  * importing every module of apf_quadruped_tpu_torch leaves both jax and
    the JAX package out of sys.modules, and loads no file from the JAX
    package's directory (checked in a fresh interpreter); no code of the
    port names that directory; the scripts that run on the GPU machine
    import neither;
  * the port's copies of the JAX package's pure-Python files (config,
    DogBot constants, the robot zoo, the plots) agree with them;
  * the entry points run on the card unless asked for the CPU, and raise
    without one;
  * without nvcc, building a CUDA kernel raises instead of returning;
  * no solver option of the JAX package is left out: stage_bf16, the last
    to be ported, runs (tests/test_torch_stage_bf16.py holds it to the JAX
    package).
"""

import ast
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from apf_quadruped_tpu_torch import _kernels, planner, problems
from apf_quadruped_tpu_torch.config import (EngineConfig, GaitConfig, MpcConfig,
                                            SimConfig, SolverConfig)
from apf_quadruped_tpu_torch.ops import riccati

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SLICE = ["apf_quadruped_tpu_torch", "apf_quadruped_tpu_torch.config",
         "apf_quadruped_tpu_torch._precision", "apf_quadruped_tpu_torch._kernels",
         "apf_quadruped_tpu_torch._device",
         "apf_quadruped_tpu_torch.models.dogbot",
         "apf_quadruped_tpu_torch.models.srb",
         "apf_quadruped_tpu_torch.ops.rotations",
         "apf_quadruped_tpu_torch.ops.qpsolve",
         "apf_quadruped_tpu_torch.ops.riccati",
         "apf_quadruped_tpu_torch.ops.cuda_riccati",
         "apf_quadruped_tpu_torch.gait", "apf_quadruped_tpu_torch.planner",
         "apf_quadruped_tpu_torch.convert", "apf_quadruped_tpu_torch.problems",
         "apf_quadruped_tpu_torch.ops.chol",
         "apf_quadruped_tpu_torch.ops.cuda_chol",
         "apf_quadruped_tpu_torch.ops.cuda_qp",
         "apf_quadruped_tpu_torch.models.kinematics",
         "apf_quadruped_tpu_torch.models.rbd",
         "apf_quadruped_tpu_torch.wbc", "apf_quadruped_tpu_torch.swing",
         "apf_quadruped_tpu_torch.apf", "apf_quadruped_tpu_torch.foothold",
         "apf_quadruped_tpu_torch.sim.terrain",
         "apf_quadruped_tpu_torch.sim.disturbance",
         "apf_quadruped_tpu_torch.sim.physics",
         "apf_quadruped_tpu_torch.runtime.observer",
         "apf_quadruped_tpu_torch.runtime.loop",
         "apf_quadruped_tpu_torch.runtime.graph",
         "apf_quadruped_tpu_torch.runtime.sweep",
         "apf_quadruped_tpu_torch.runtime.native",
         "apf_quadruped_tpu_torch.runtime.checkpoint",
         "apf_quadruped_tpu_torch.runtime.profiling",
         "apf_quadruped_tpu_torch.runtime.viz",
         "apf_quadruped_tpu_torch.models.zoo",
         "apf_quadruped_tpu_torch.parallel",
         "apf_quadruped_tpu_torch.parallel.mesh",
         "apf_quadruped_tpu_torch.parallel.distributed",
         "apf_quadruped_tpu_torch.__main__"]


def test_slice_imports_no_jax():
    jax_pkg = str(ROOT / "apf_quadruped_tpu") + os.sep
    code = ("import importlib, os, sys\n"
            f"for m in {SLICE!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'apf_quadruped_tpu' "
            "or m.startswith('apf_quadruped_tpu.'))\n"
            "assert not bad, bad\n"
            "files = sorted(m for m, mod in list(sys.modules.items()) "
            "if os.path.realpath(getattr(mod, '__file__', None) or '')"
            f".startswith({jax_pkg!r}))\n"
            "assert not files, files\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("script", ["chip_smoke.py", "ipm_phases.py",
                                    "spd_turns.py", "fused_turns.py",
                                    "bf16_turns.py",
                                    "tests/test_torch_cuda.py"])
def test_gpu_scripts_import_no_jax(script):
    """What runs on the GPU machine, which has no JAX, imports none of it
    and nothing of the JAX package."""
    imported = set()
    for node in ast.walk(ast.parse((ROOT / script).read_text())):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
    tops = {m.split(".")[0] for m in imported}
    assert not tops & {"jax", "jaxlib", "apf_quadruped_tpu"}, tops
    assert "apf_quadruped_tpu_torch" in tops


def test_every_package_module_is_checked():
    pkg = ROOT / "apf_quadruped_tpu_torch"
    found = {".".join(p.relative_to(ROOT).with_suffix("").parts)
             for p in pkg.rglob("*.py")}
    found = {m.removesuffix(".__init__") for m in found}
    missing = found - set(SLICE) - {"apf_quadruped_tpu_torch.models",
                                    "apf_quadruped_tpu_torch.ops",
                                    "apf_quadruped_tpu_torch.sim",
                                    "apf_quadruped_tpu_torch.runtime"}
    assert not missing, missing


@pytest.mark.parametrize("loader", ["resident_ipm", "spd_chol",
                                    "fused_riccati"])
def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path, loader):
    if shutil.which("nvcc") or Path(os.environ.get(
            "CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc").is_file():
        pytest.skip("nvcc is installed here; the build itself is exercised "
                    "by chip_smoke.py")
    monkeypatch.setattr(_kernels, "BUILD_ROOT", tmp_path)
    load = getattr(_kernels, loader)
    load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            load()
    finally:
        load.cache_clear()
    assert not list(tmp_path.rglob("*.so"))


def test_sweep_robot_outside_the_choices_is_an_argparse_error(capsys):
    """--robot takes the JAX CLI's choices (dogbot, anymal, hyq): a typo
    exits with argparse's code 2 before anything runs."""
    from apf_quadruped_tpu_torch.__main__ import main
    with pytest.raises(SystemExit) as exc:
        main(["sweep", "--robot", "dogbo", "--device", "cpu"])
    assert exc.value.code == 2
    assert "invalid choice: 'dogbo'" in capsys.readouterr().err


def test_spd_solve_on_cpu_takes_the_plain_version():
    """CPU tensors never reach the kernel wrappers (no launch counted)."""
    from apf_quadruped_tpu_torch.ops import chol, cuda_chol
    H = torch.eye(5, dtype=torch.float64).expand(2, 5, 5) * 4.0
    before = (cuda_chol.chol_factor.launches, cuda_chol.chol_sub.launches)
    L, d = chol.spd_factor(H)
    x = chol.spd_solve((L, d), torch.ones(2, 5, dtype=torch.float64))
    assert torch.equal(x, torch.full((2, 5), 0.25, dtype=torch.float64))
    assert (cuda_chol.chol_factor.launches,
            cuda_chol.chol_sub.launches) == before


@pytest.mark.parametrize("option", ["stage_bf16"])
def test_unported_solver_options_raise(option):
    """The option that raised until it was ported no longer does: the plan
    on the CPU (the scan, which ignores it as the JAX scan does) and the
    scan itself run with it set and give the float32 answer."""
    cfg = EngineConfig(mpc=MpcConfig(horizon=4),
                       solver=SolverConfig(**{option: True}))
    x0, refs = problems.bench_problem(cfg, 2, device="cpu")
    out = planner.plan(cfg, x0, refs)
    ref = planner.plan(dataclasses.replace(cfg, solver=SolverConfig()), x0,
                       refs)
    assert torch.equal(out.forces, ref.forces)
    qp = planner.stage_qp(cfg, x0, refs)
    assert torch.equal(riccati.solve_stage_qp(qp, cfg.solver).u,
                       riccati.solve_stage_qp(qp, SolverConfig()).u)


def test_unknown_backend_raises():
    cfg = EngineConfig(mpc=MpcConfig(horizon=4, backend="bogus"))
    with pytest.raises(ValueError, match="bogus"):
        planner.effective_backend(cfg, "cpu")


def test_precision_guard_restores_settings():
    from apf_quadruped_tpu_torch._precision import highest_precision
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.set_float32_matmul_precision("medium")
    try:
        with highest_precision():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.backends.cudnn.allow_tf32 = before[1]
        torch.set_float32_matmul_precision(before[2])


def _default(field):
    """A field's default, a nested config as a dict (the two packages'
    classes are distinct types)."""
    v = (field.default_factory() if field.default_factory
         is not dataclasses.MISSING else field.default)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def test_config_is_shared_not_copied():
    """The port keeps its own copy of the JAX package's config (no file is
    shared), and the copy agrees with it: every dataclass has the same
    field names and defaults, and the default trees are equal."""
    from apf_quadruped_tpu import config as jcfg
    from apf_quadruped_tpu_torch import config as tcfg
    assert Path(tcfg.__file__).parent == ROOT / "apf_quadruped_tpu_torch"
    classes = [v for v in vars(jcfg).values()
               if dataclasses.is_dataclass(v) and v.__module__ == jcfg.__name__]
    assert len(classes) >= 10
    for jc in classes:
        tc = getattr(tcfg, jc.__name__)
        assert tc.__module__ == tcfg.__name__
        jf, tf = dataclasses.fields(jc), dataclasses.fields(tc)
        assert [f.name for f in tf] == [f.name for f in jf], jc.__name__
        for a, b in zip(jf, tf):
            assert _default(a) == _default(b), (jc.__name__, a.name)
    assert dataclasses.asdict(tcfg.EngineConfig()) == \
        dataclasses.asdict(jcfg.EngineConfig())


def test_dogbot_copy_matches_jax():
    """The port's copy of the DogBot constants gives the JAX package's
    numbers; default_joint_angles goes through the port's kinematics."""
    import numpy as np

    from apf_quadruped_tpu import config as jcfg
    from apf_quadruped_tpu.models import dogbot as jdog
    from apf_quadruped_tpu_torch.models import dogbot as tdog
    robot = jcfg.RobotConfig()
    for name in ("nominal_stance", "hip_positions", "inertia_matrix"):
        np.testing.assert_array_equal(getattr(tdog, name)(robot),
                                      getattr(jdog, name)(robot))
    np.testing.assert_array_equal(tdog.repulsive_versors(),
                                  jdog.repulsive_versors())
    for a, b in zip(tdog.joint_limits(robot), jdog.joint_limits(robot)):
        np.testing.assert_array_equal(a, b)
    q = tdog.default_joint_angles(robot)
    assert isinstance(q, torch.Tensor)
    np.testing.assert_allclose(q.numpy(), np.asarray(
        jdog.default_joint_angles(robot)), atol=1e-6)


def _body(path, replace=()):
    """The module's code without its docstring, as an AST dump, after
    replacing the string constants `replace` names."""
    tree = ast.parse(path.read_text())
    body = tree.body[1:] if isinstance(tree.body[0], ast.Expr) else tree.body
    for node in ast.walk(ast.Module(body=body, type_ignores=[])):
        if isinstance(node, ast.Constant) and node.value in dict(replace):
            node.value = dict(replace)[node.value]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


@pytest.mark.parametrize("module,replace", [
    ("models/zoo.py", ()),
    ("runtime/viz.py", (("apf_quadruped_tpu run",
                         "apf_quadruped_tpu_torch run"),))])
def test_pure_python_copies_match_jax(module, replace):
    """models/zoo.py and runtime/viz.py are copies of the JAX package's:
    the same code apart from the docstring (and viz's default title,
    which names the port)."""
    assert _body(ROOT / "apf_quadruped_tpu_torch" / module) == \
        _body(ROOT / "apf_quadruped_tpu" / module, replace)


def test_zoo_copy_gives_the_jax_configs():
    """Every zoo model, its RobotConfig and its closed-loop EngineConfig
    equal the JAX package's."""
    import numpy as np

    from apf_quadruped_tpu.models import zoo as jzoo
    from apf_quadruped_tpu_torch.models import zoo as tzoo
    assert set(tzoo.ZOO) == set(jzoo.ZOO)
    for name in tzoo.ZOO:
        tm, jm = tzoo.ZOO[name](), jzoo.ZOO[name]()
        for a, b in zip(tm, jm):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert dataclasses.asdict(tzoo.robot_config_for(tm)) == \
            dataclasses.asdict(jzoo.robot_config_for(jm))
        assert dataclasses.asdict(tzoo.engine_config_for(name)) == \
            dataclasses.asdict(jzoo.engine_config_for(name))


_JAX_DIR = re.compile(r"(?<![\w.])apf_quadruped_tpu(?![\w])")


def _code_strings(path):
    """The string constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_no_port_code_names_the_jax_package_directory():
    """No code of the port (string constants outside docstrings, imports)
    names apf_quadruped_tpu/ as a path or module: the port reads and
    writes nothing there."""
    pkg = ROOT / "apf_quadruped_tpu_torch"
    for path in sorted(pkg.rglob("*.py")):
        bad = [s for s in _code_strings(path) if _JAX_DIR.search(s)]
        assert not bad, (path, bad)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module:
                assert node.module.split(".")[0] != "apf_quadruped_tpu", path
            elif isinstance(node, ast.Import):
                assert all(a.name.split(".")[0] != "apf_quadruped_tpu"
                           for a in node.names), path


def test_native_generator_builds_inside_the_port():
    from apf_quadruped_tpu_torch.runtime import native
    assert Path(native._SO_PATH).resolve().parent == \
        ROOT / "apf_quadruped_tpu_torch" / "_build"
    assert Path(native._SRC).resolve() == ROOT / "native" / "scenario_gen.cpp"


def _entry_points():
    from apf_quadruped_tpu_torch import __main__ as cli
    from apf_quadruped_tpu_torch.runtime import loop, sweep
    cfg = EngineConfig(mpc=MpcConfig(horizon=4))
    return {"bench_problem": lambda **kw: problems.bench_problem(cfg, 2, **kw),
            "random_scenarios": lambda **kw: sweep.random_scenarios(
                cfg, 2, use_native=False, **kw),
            "loop.init": lambda **kw: loop.init(cfg, 2, **kw),
            "run_closed_loop": lambda **kw: cli.run_closed_loop(
                cfg.replace(gait=GaitConfig(trot_cycle=0.0125),
                            sim=SimConfig(substeps=1, terrain_res=16)),
                cycles=1, **kw)[0],
            "bench_rate": lambda **kw: cli.bench_rate(
                B=2, bursts=1, reps=1, **kw).values()}


@pytest.mark.parametrize("entry", ["bench_problem", "random_scenarios",
                                   "loop.init", "run_closed_loop",
                                   "bench_rate"])
def test_entry_points_default_to_the_card(entry):
    """Without a device the entry points ask for the card: without one
    they raise and name the CPU option; with device='cpu' they run."""
    call = _entry_points()[entry]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py drives the "
                    "entry points there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    out = call(device="cpu")
    leaves = [v for v in out if isinstance(v, torch.Tensor)]
    if entry == "bench_rate":
        assert "solves/s" in out
    else:
        assert leaves and all(v.device.type == "cpu" for v in leaves)


def test_sweep_command_needs_the_card_or_device_cpu():
    from apf_quadruped_tpu_torch.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the command would run there")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["sweep", "--batch", "2", "--cycles", "1"])


@pytest.mark.parametrize("argv", [["run", "--cycles", "1"], ["bench"]])
def test_run_and_bench_commands_need_the_card_or_device_cpu(argv):
    from apf_quadruped_tpu_torch.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the command would run there")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)


@pytest.mark.parametrize("devices", [None, ["cuda:0", "cuda:0"]])
def test_sharded_sweep_defaults_to_the_cards(devices):
    """run_sharded and run_resumable(devices=...) split over the CUDA
    cards unless given CPU devices: without a card they raise."""
    from apf_quadruped_tpu_torch.runtime import sweep
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py drives the "
                    "sharded sweep there")
    cfg = EngineConfig(mpc=MpcConfig(horizon=4))
    scn = sweep.random_scenarios(cfg, 2, use_native=False, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.run_sharded(cfg, scn, 1, devices=devices)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.run_resumable(cfg, scn, 1, devices=devices or ["cuda"])
