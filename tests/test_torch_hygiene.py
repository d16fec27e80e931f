"""The port's boundaries: no JAX inside it, no hidden fallbacks.

  * importing every module of apf_quadruped_tpu_torch leaves both jax and
    the JAX package out of sys.modules (checked in a fresh interpreter),
    and the scripts that run on the GPU machine import neither;
  * without nvcc, building a CUDA kernel raises instead of returning;
  * backends, solver options and sweep drivers that are not ported raise.
"""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from apf_quadruped_tpu_torch import _kernels, planner, problems
from apf_quadruped_tpu_torch.config import EngineConfig, MpcConfig, SolverConfig
from apf_quadruped_tpu_torch.ops import riccati

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SLICE = ["apf_quadruped_tpu_torch", "apf_quadruped_tpu_torch.config",
         "apf_quadruped_tpu_torch._precision", "apf_quadruped_tpu_torch._kernels",
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
         "apf_quadruped_tpu_torch.models.kinematics",
         "apf_quadruped_tpu_torch.models.rbd",
         "apf_quadruped_tpu_torch.wbc", "apf_quadruped_tpu_torch.swing",
         "apf_quadruped_tpu_torch.apf", "apf_quadruped_tpu_torch.foothold",
         "apf_quadruped_tpu_torch.sim.terrain",
         "apf_quadruped_tpu_torch.sim.disturbance",
         "apf_quadruped_tpu_torch.sim.physics",
         "apf_quadruped_tpu_torch.runtime.observer",
         "apf_quadruped_tpu_torch.runtime.loop",
         "apf_quadruped_tpu_torch.runtime.sweep",
         "apf_quadruped_tpu_torch.__main__"]


def test_slice_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'apf_quadruped_tpu' "
            "or m.startswith('apf_quadruped_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("script", ["chip_smoke.py", "tests/test_torch_cuda.py"])
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
    missing = found - set(SLICE) - {"apf_quadruped_tpu_torch._shared",
                                    "apf_quadruped_tpu_torch.models",
                                    "apf_quadruped_tpu_torch.ops",
                                    "apf_quadruped_tpu_torch.sim",
                                    "apf_quadruped_tpu_torch.runtime"}
    assert not missing, missing


@pytest.mark.parametrize("loader", ["resident_ipm", "spd_chol"])
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


@pytest.mark.parametrize("driver,item", [("run_resumable", "15"),
                                         ("step_batch_sharded", "17"),
                                         ("run_sharded", "17")])
def test_unported_sweep_drivers_raise(driver, item):
    from apf_quadruped_tpu_torch.runtime import sweep
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, item "
                       f"{item}"):
        getattr(sweep, driver)(sweep.cli_config(), None, 1)


@pytest.mark.parametrize("argv", [["run"], ["bench"], ["sweep", "--sharded"],
                                  ["sweep", "--checkpoint", "ckpt"]])
def test_unported_cli_commands_raise(argv):
    from apf_quadruped_tpu_torch.__main__ import main
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 16"):
        main(argv)


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


@pytest.mark.parametrize("backend", ["riccati_fused", "condensed"])
def test_unported_backends_raise(backend):
    cfg = EngineConfig(mpc=MpcConfig(horizon=4, backend=backend))
    x0, refs = problems.bench_problem(cfg, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        planner.plan(cfg, x0, refs)


@pytest.mark.parametrize("option", ["use_pallas", "stage_bf16"])
def test_unported_solver_options_raise(option):
    cfg = EngineConfig(mpc=MpcConfig(horizon=4),
                       solver=SolverConfig(**{option: True}))
    x0, refs = problems.bench_problem(cfg, 2)
    with pytest.raises(NotImplementedError, match=option):
        planner.plan(cfg, x0, refs)
    with pytest.raises(NotImplementedError, match=option):
        riccati.solve_stage_qp(planner.stage_qp(cfg, x0, refs), cfg.solver)


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


def test_config_is_shared_not_copied():
    """The port's config classes are the JAX package's dataclasses, loaded
    from the same file."""
    from apf_quadruped_tpu import config as jcfg
    from apf_quadruped_tpu_torch import config as tcfg
    assert Path(sys.modules[tcfg.EngineConfig.__module__].__file__) == \
        Path(jcfg.__file__)
    assert dataclasses.asdict(tcfg.EngineConfig()) == \
        dataclasses.asdict(jcfg.EngineConfig())
