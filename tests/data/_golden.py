"""What the closed-loop golden generators share (make_switch_golden.py,
make_world_golden.py, make_option_golden.py): the float64 twins, the flat
key names of a NamedTuple tree, and main(), which writes a golden from a
float64 and a float32 process of the JAX package on the CPU.

Each generator defines `run(dtype_name, path)`, which writes the runs of
one dtype ("f64": the reference and its three twins; "f32": float32,
without jax_enable_x64, and its three twins) to `path`, and calls
`main(OUT, __file__, run)`.
"""

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

# the float64 twins of tests/data/make_mode_golden.py: the start's joint
# angles q moved by +-1e-12 rad, its base position by 1e-14 m.  Their
# distances from the float64 run are how far the loop itself carries a
# rounding, the spread the port's float64 run is held within
TWINS = {"f64p": ("q", 1e-12), "f64m": ("q", -1e-12),
         "f64b": ("p_base", 1e-14)}
# the float32 twins: the float32 run from a start whose joint angles q are
# moved by one float32 rounding (one ulp, up or down), or its base position
# by one ulp up.  Their distances from the float32 run are how far the loop
# carries one float32 rounding: samples of the spread between two float32
# routes that sum in different orders, which chip_smoke.py's golden_gate
# allows the port's float32 run
F32_TWINS = {"f32p": ("q", 1), "f32m": ("q", -1), "f32b": ("p_base", 1)}
ROOT = Path(__file__).resolve().parents[2]
# the repository root, so that the generators find the JAX package
sys.path.insert(0, str(ROOT))


def leaves(prefix, tree, batch_axis=False):
    """{prefix.field[.field]: numpy} of a NamedTuple tree (with a leading
    batch axis of 1 added when `batch_axis`, as the port's batched loop
    gives an unbatched JAX run)."""
    out = {}
    for name, value in tree._asdict().items():
        key = f"{prefix}.{name}"
        if hasattr(value, "_asdict"):
            out.update(leaves(key, value, batch_axis))
        elif value is not None:
            out[key] = np.asarray(value)[None] if batch_axis \
                else np.asarray(value)
    return out


def runs_of(dtype_name):
    """The run names one process writes."""
    return (("f64",) + tuple(TWINS) if dtype_name == "f64"
            else ("f32",) + tuple(F32_TWINS))


def jax_dtype(dtype_name):
    """The JAX dtype of a process (float64 switched on for "f64")."""
    import jax

    if dtype_name == "f64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    return jnp.float64 if dtype_name == "f64" else jnp.float32


def moved(st, name):
    """LoopState `st` with the start of run `name` (a twin's moved leaf)."""
    if name in F32_TWINS:
        import jax.numpy as jnp

        leaf, sign = F32_TWINS[name]
        v = getattr(st.sim, leaf)
        return st._replace(sim=st.sim._replace(
            **{leaf: jnp.nextafter(v, v + sign * jnp.inf)}))
    if name not in TWINS:
        return st
    leaf, dx = TWINS[name]
    return st._replace(sim=st.sim._replace(
        **{leaf: getattr(st.sim, leaf) + dx}))


def save(path, data, dtype_name):
    for k, v in data.items():
        assert v.dtype != np.float64 or dtype_name == "f64", \
            f"{k} is float64 in the float32 run"
    np.savez(path, **data)


def main(out: Path, script: str, run, check=None):
    """`script f64|f32 <path>` writes one dtype's runs; with no arguments
    both processes run side by side and their runs are merged into `out`
    (the float32 process's scenario keys, "scn.*" and "scn_*", must be the
    float64 ones, rounded),
    after `check(data)` if given."""
    if len(sys.argv) == 3:
        run(sys.argv[1], sys.argv[2])
        return
    data = {}
    with tempfile.TemporaryDirectory() as tmp:
        parts = {name: str(Path(tmp) / f"{name}.npz")
                 for name in ("f64", "f32")}
        procs = [subprocess.Popen([sys.executable, script, name, part])
                 for name, part in parts.items()]
        for p in procs:
            if p.wait():
                raise SystemExit(f"{p.args} exited with {p.returncode}")
        for name, part in parts.items():
            with np.load(part) as f:
                part_data = {k: f[k] for k in f.files}
            if name == "f32":
                for k in [k for k in part_data if k.startswith("scn")]:
                    np.testing.assert_array_equal(
                        part_data.pop(k), data[k].astype(np.float32),
                        err_msg=k)
            data.update(part_data)
    if check is not None:
        check(data)
    np.savez_compressed(out, **data)
    print(f"wrote {out}: {len(data)} arrays, {out.stat().st_size} bytes")
