"""The benchmark's copies of the traffic generators: deterministic by
seed, and drawing what the program's generators draw."""

from __future__ import annotations

import numpy as np

from portbench import gen, spec

CONF = spec.cell("dogbot_trot.sweep_b1024").config


def _rcfg():
    return spec.reference_config(CONF)


def test_rng_by_seed_and_stream():
    a = gen.rng(2 ** 40 + 3, 1, 0).uniform(size=4)
    assert np.array_equal(a, gen.rng(2 ** 40 + 3, 1, 0).uniform(size=4))
    assert not np.array_equal(a, gen.rng(2 ** 40 + 3, 1, 1).uniform(size=4))
    assert not np.array_equal(a, gen.rng(2 ** 40 + 4, 1, 0).uniform(size=4))
    gen.rng(-5, 1).uniform()       # any whole number is a seed


def test_scenarios_are_the_programs_numpy_path():
    from apf_quadruped_tpu_torch.runtime import sweep as psweep
    cfg = spec.program_config(CONF)
    ours = gen.scenarios(_rcfg(), 6, np.random.default_rng(11), 4,
                         (-0.6, 0.6), (1.2, 2.2), 2, 40.0, 4.0)
    theirs = psweep.random_scenarios(cfg, 6, seed=11, use_native=False,
                                     device="cpu")
    for k, v in ours.items():
        assert np.array_equal(v, getattr(theirs, k).numpy()), k
    again = gen.scenarios(_rcfg(), 6, np.random.default_rng(11), 4,
                          (-0.6, 0.6), (1.2, 2.2), 2, 40.0, 4.0)
    assert all(np.array_equal(v, again[k]) for k, v in ours.items())


def test_plan_problems_are_bench_problem():
    from apf_quadruped_tpu_torch import problems
    cfg = spec.program_config(CONF)
    ours = gen.plan_problems(_rcfg(), 5, np.random.default_rng(3))
    x0, refs = problems.bench_problem(cfg, 5, seed=3, device="cpu")
    np.testing.assert_allclose(ours["x0"], x0.numpy(), rtol=0, atol=1e-6)
    for k in ("contacts", "feet_w", "x_ref", "yaw_ref"):
        np.testing.assert_allclose(ours[k], getattr(refs, k).numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_plan_problems_deal_their_gait_flags():
    """One flag is bench.py's problem bit for bit; several are dealt evenly
    over the lanes in a seeded order, each lane's contacts the flag's
    schedule over the horizon, which for the adaptive configuration is
    the loop's own crawl cycle; the state's draws do not move."""
    import torch

    from portbench.reference import gait
    base = gen.plan_problems(_rcfg(), 6, gen.rng(5, 4))
    ones = gen.plan_problems(_rcfg(), 6, gen.rng(5, 4), [1])
    assert all(np.array_equal(v, ones[k]) for k, v in base.items())
    ref = spec.reference_config(spec.cell("dogbot_adaptive.plan_b1024").config)
    H, dt = ref.mpc.horizon, ref.mpc.dt
    assert H * dt == ref.gait.crawl_cycle
    mixed = gen.plan_problems(ref, 6, gen.rng(5, 4), [4, 15])
    again = gen.plan_problems(ref, 6, gen.rng(5, 4), [4, 15])
    assert all(np.array_equal(v, again[k]) for k, v in mixed.items())
    plain = gen.plan_problems(ref, 6, gen.rng(5, 4))
    for k in ("x0", "yaw_ref"):
        assert np.array_equal(mixed[k], plain[k]), k

    def sched(flag):
        return gait.horizon_contacts(
            torch.tensor([flag]), torch.zeros(1, dtype=torch.float64), dt, H,
            torch.tensor([H * dt], dtype=torch.float64),
            dtype=torch.float64)[0].numpy()
    of = [[f for f in (4, 15) if np.array_equal(c, sched(f))]
          for c in mixed["contacts"]]
    assert all(len(f) == 1 for f in of)
    assert sorted(f[0] for f in of) == [4, 4, 4, 15, 15, 15]
    assert not np.array_equal(sched(4), sched(15))
    orders = {tuple(np.argsort(gen.plan_problems(
        ref, 6, gen.rng(s, 4), [4, 15])["contacts"].sum(axis=(1, 2)),
        kind="stable")) for s in range(6)}
    assert len(orders) > 1


def test_wbc_states_are_wbc_problem():
    from apf_quadruped_tpu_torch import problems
    cfg = spec.program_config(CONF)
    ours = gen.wbc_states(_rcfg(), 5, np.random.default_rng(4))
    st, ref = problems.wbc_problem(cfg, 5, seed=4, device="cpu")
    for k in ("p_base", "R_wb", "q", "u", "contact", "cone_rot"):
        np.testing.assert_allclose(ours[k], getattr(st, k).numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert not ours["crawl"].any() and not st.crawl.any()
    for k in ref._fields:
        np.testing.assert_allclose(ours[k], getattr(ref, k).numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_inputs_are_float32():
    for d in (gen.plan_problems(_rcfg(), 2, gen.rng(1, 2)),
              gen.wbc_states(_rcfg(), 2, gen.rng(1, 3))):
        assert all(v.dtype in (np.float32, np.bool_) for v in d.values())
