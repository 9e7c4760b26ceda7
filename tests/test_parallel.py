"""Distributed tests on the 8-virtual-device CPU mesh (SURVEY §4 level 4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from plasma_control_tpu.config import ControlConfig, MPCConfig, SimConfig
from plasma_control_tpu.control.actuator import make_actuator
from plasma_control_tpu.control.mpc import candidate_costs, plan
from plasma_control_tpu.models.pic import PlasmaState, init_state, step
from plasma_control_tpu.ops.grid import make_grid
from plasma_control_tpu.parallel.mesh import make_mesh, shard_batch
from plasma_control_tpu.parallel.pic_shard import (
    make_particle_sharded_step,
    make_sharded_candidate_costs,
    sharded_plan,
)


def cfgs(**kw):
    base = dict(n_particles=1024, n_mesh=32, dt=0.1, t_max=5.0, length=50.0)
    base.update(kw)
    return SimConfig(**base)


@pytest.fixture(scope="module")
def devices8():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual CPU devices"
    return jax.devices()


class TestParticleSharding:
    def test_sharded_step_matches_single_device(self, devices8):
        cfg = cfgs()
        grid = make_grid(cfg.n_mesh, cfg.length)
        mesh = make_mesh(axis_names=("particle",))
        st = init_state(cfg, jax.random.PRNGKey(0))

        ref = step(st, grid, cfg, jnp.zeros(cfg.n_mesh))

        sharded_step = make_particle_sharded_step(mesh, grid, cfg)
        x_s, v_s = shard_batch((st.x, st.v), mesh, axis="particle")
        x2, v2 = sharded_step(x_s, v_s, jnp.zeros(cfg.n_mesh))

        np.testing.assert_allclose(np.asarray(x2), np.asarray(ref.x), atol=1e-4)
        np.testing.assert_allclose(np.asarray(v2), np.asarray(ref.v), atol=1e-4)

    def test_sharded_step_with_external_field(self, devices8):
        cfg = cfgs()
        grid = make_grid(cfg.n_mesh, cfg.length)
        mesh = make_mesh(axis_names=("particle",))
        st = init_state(cfg, jax.random.PRNGKey(3))
        e_ext = jnp.asarray(0.1 * np.sin(2 * np.pi * np.arange(cfg.n_mesh) / cfg.n_mesh), dtype=jnp.float32)

        ref = step(st, grid, cfg, e_ext)
        sharded_step = make_particle_sharded_step(mesh, grid, cfg)
        x_s, v_s = shard_batch((st.x, st.v), mesh, axis="particle")
        x2, v2 = sharded_step(x_s, v_s, e_ext)
        np.testing.assert_allclose(np.asarray(v2), np.asarray(ref.v), atol=1e-4)


class TestRolloutSharding:
    def test_sharded_costs_match_vmap(self, devices8):
        cfg = cfgs()
        mpc = MPCConfig(horizon=3, n_candidates=16)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, 2)
        st = init_state(cfg, jax.random.PRNGKey(0))
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (16, 3, 4))

        ref = np.asarray(candidate_costs(st, cand, grid, cfg, mpc, act))

        mesh = make_mesh(axis_names=("rollout",))
        costs_fn = make_sharded_candidate_costs(mesh, grid, cfg, mpc, act)
        got = np.asarray(costs_fn(st, jax.device_put(cand, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("rollout")))))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    def test_sharded_plan_runs(self, devices8):
        cfg = cfgs()
        mpc = MPCConfig(horizon=3, n_candidates=32)
        ctrl = ControlConfig(max_mode=2)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        mesh = make_mesh(axis_names=("rollout",))
        action, new_mean, best = sharded_plan(
            st, jnp.zeros((3, 4)), jnp.asarray(0.3), jax.random.PRNGKey(2), mesh, grid, cfg, ctrl, mpc, act
        )
        assert action.shape == (4,)
        assert np.isfinite(float(best))


class TestMesh2D:
    def test_2d_mesh_construction(self, devices8):
        mesh = make_mesh(axis_sizes=(4, 2), axis_names=("rollout", "particle"))
        assert mesh.shape == {"rollout": 4, "particle": 2}


class TestLargeNSharding:
    def test_million_scale_particle_step(self, devices8):
        """Particle axis sharded over 8 devices at large N (config-5 shape,
        scaled down for CI): one step runs and conserves charge."""
        import jax.numpy as jnp
        from plasma_control_tpu.ops.deposit import deposit

        cfg = cfgs(n_particles=2**16, n_mesh=128)
        grid = make_grid(cfg.n_mesh, cfg.length)
        mesh = make_mesh(axis_names=("particle",))
        st = init_state(cfg, jax.random.PRNGKey(0))
        step_fn = make_particle_sharded_step(mesh, grid, cfg)
        x, v = shard_batch((st.x, st.v), mesh, axis="particle")
        x2, v2 = step_fn(x, v, jnp.zeros(cfg.n_mesh))
        n = deposit(jnp.asarray(x2), grid)
        total = float(jnp.sum(n)) * grid.dx
        assert abs(total - cfg.length) < 1e-2


class TestGSPMDCandidateSharding:
    def test_sharded_plan_matches_unsharded(self, devices8):
        """plan() with a candidate sharding constraint must produce the same
        action as the single-device run (GSPMD partitioning is semantics-
        preserving)."""
        from plasma_control_tpu.control.mpc import plan

        cfg = cfgs()
        mpc = MPCConfig(horizon=3, n_candidates=16)
        ctrl = ControlConfig(max_mode=2)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        mesh = make_mesh(axis_names=("rollout",))
        sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("rollout"))

        mean = jnp.zeros((3, 4))
        a0, m0, b0 = plan(st, mean, jnp.asarray(0.3), jax.random.PRNGKey(5), grid, cfg, ctrl, mpc, act)
        a1, m1, b1 = plan(st, mean, jnp.asarray(0.3), jax.random.PRNGKey(5), grid, cfg, ctrl, mpc, act, candidate_sharding=sh)
        np.testing.assert_allclose(np.asarray(a0), np.asarray(a1), atol=1e-5)
        assert abs(float(b0) - float(b1)) < 1e-3

    def test_sharded_closed_loop(self, devices8):
        """Full receding-horizon loop with GSPMD-sharded candidates."""
        from plasma_control_tpu.control.mpc import mpc_rollout

        cfg = cfgs(t_max=2.0)
        mpc = MPCConfig(horizon=3, n_candidates=16)
        ctrl = ControlConfig(max_mode=2)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        mesh = make_mesh(axis_names=("rollout",))
        sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("rollout"))
        out = mpc_rollout(st, grid, cfg, ctrl, mpc, act, jax.random.PRNGKey(1), candidate_sharding=sh)
        assert np.isfinite(np.asarray(out.field_energy)).all()


class TestShardedFusedSpectral:
    def test_sharded_costs_with_fused_spectral_kernel(self, devices8,
                                                      spectral_kernel_interpreted):
        """candidate_costs under shard_map with the whole-horizon spectral
        kernel (interpret mode on CPU): each device runs the kernel on its
        local candidate block; costs match the unsharded XLA path."""
        from plasma_control_tpu.parallel.pic_shard import make_sharded_candidate_costs

        cfg = cfgs(n_particles=256)
        ctrl = ControlConfig(max_mode=2)
        mpc = MPCConfig(horizon=3, n_candidates=32, plan_modes=4, plan_kernel="fused")
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (32, 3, 4))

        mesh = make_mesh(axis_names=("rollout",))
        costs_fn = make_sharded_candidate_costs(mesh, grid, cfg, mpc, act)
        c_sharded = np.asarray(costs_fn(st, cand))

        mpc_xla = MPCConfig(horizon=3, n_candidates=32, plan_modes=4, plan_kernel="xla")
        c_ref = np.asarray(candidate_costs(st, cand, grid, cfg, mpc_xla, act))
        np.testing.assert_allclose(c_sharded, c_ref, rtol=2e-4, atol=1e-6)

    def test_sharded_costs_with_plan_chunk(self, devices8):
        """plan_chunk (the large-N memory bound) composes with shard_map:
        each device chunks its LOCAL candidate block (32/8 devices = 4 local
        candidates, chunk 2), and costs still match the unsharded path."""
        from plasma_control_tpu.parallel.pic_shard import make_sharded_candidate_costs

        cfg = cfgs(n_particles=256)
        ctrl = ControlConfig(max_mode=2)
        mpc = MPCConfig(horizon=3, n_candidates=32, plan_modes=4, plan_chunk=2)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        cand = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (32, 3, 4))

        mesh = make_mesh(axis_names=("rollout",))
        costs_fn = make_sharded_candidate_costs(mesh, grid, cfg, mpc, act)
        c_sharded = np.asarray(costs_fn(st, cand))
        c_ref = np.asarray(candidate_costs(
            st, cand, grid, cfg,
            MPCConfig(horizon=3, n_candidates=32, plan_modes=4), act))
        np.testing.assert_allclose(c_sharded, c_ref, rtol=2e-4, atol=1e-6)

    def test_gspmd_constraint_path_rejects_pallas_kernels(self, devices8):
        """plan(candidate_sharding=...) is the GSPMD path — the planning
        kernel only composes with several devices via shard_map
        (sharded_plan); forcing it is a config error, and 'auto' uses XLA."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        cfg = cfgs(n_particles=256)
        ctrl = ControlConfig(max_mode=2)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        mesh = make_mesh(axis_names=("rollout",))
        sh = NamedSharding(mesh, P("rollout"))
        mean = jnp.zeros((3, 4))
        with pytest.raises(ValueError, match="shard_map"):
            plan(st, mean, jnp.asarray(0.3), jax.random.PRNGKey(1), grid, cfg,
                 ctrl, MPCConfig(horizon=3, n_candidates=32, plan_kernel="fused"),
                 act, candidate_sharding=sh)
        # auto: falls back to XLA, runs fine
        a, nm, best = plan(st, mean, jnp.asarray(0.3), jax.random.PRNGKey(1),
                           grid, cfg, ctrl, MPCConfig(horizon=3, n_candidates=32),
                           act, candidate_sharding=sh)
        assert np.isfinite(float(best))


class TestUnifiedShardedPlanner:
    """VERDICT r1 #3: ONE full-featured planner, single- or multi-chip."""

    def _setup(self, **mpc_kw):
        cfg = cfgs()
        mpc = MPCConfig(horizon=4, n_candidates=32, plan_modes=4, **mpc_kw)
        ctrl = ControlConfig(max_mode=2)
        grid = make_grid(cfg.n_mesh, cfg.length)
        act = make_actuator(cfg.length, cfg.n_mesh, ctrl.max_mode)
        st = init_state(cfg, jax.random.PRNGKey(0))
        return cfg, mpc, ctrl, grid, act, st

    def test_full_featured_sharded_plan_matches_single_device(self, devices8):
        """Default config = knot sampling + antithetic + feedback seeding +
        spectral model: the sharded solve must equal the single-device solve
        (same key => same candidates; costs identical modulo fp reduction)."""
        from plasma_control_tpu.parallel.pic_shard import make_sharded_plan

        cfg, mpc, ctrl, grid, act, st = self._setup(w_terminal=2.0)
        mesh = make_mesh(axis_names=("rollout",))
        plan_fn = make_sharded_plan(mesh, grid, cfg, ctrl, mpc, act)

        mean = jnp.zeros((4, 4))
        sigma = jnp.asarray(0.3)
        k = jax.random.PRNGKey(7)
        a0, m0, b0 = plan(st, mean, sigma, k, grid, cfg, ctrl, mpc, act)
        a1, m1, b1 = plan_fn(st, mean, sigma, k)
        np.testing.assert_allclose(np.asarray(a1), np.asarray(a0), atol=1e-5)
        np.testing.assert_allclose(np.asarray(m1), np.asarray(m0), atol=1e-5)
        assert abs(float(b0) - float(b1)) < 1e-4 * max(1.0, abs(float(b0)))

    def test_sharded_plan_cem_and_fidelity_reduction(self, devices8):
        """CEM iterations + particle-subsampled plan model, sharded."""
        from plasma_control_tpu.parallel.pic_shard import make_sharded_plan

        cfg, mpc, ctrl, grid, act, st = self._setup(
            algo="cem", n_iters=2, n_elites=8, plan_particles=512
        )
        mesh = make_mesh(axis_names=("rollout",))
        plan_fn = make_sharded_plan(mesh, grid, cfg, ctrl, mpc, act)
        mean = jnp.zeros((4, 4))
        k = jax.random.PRNGKey(3)
        a0, m0, b0 = plan(st, mean, jnp.asarray(0.3), k, grid, cfg, ctrl, mpc, act)
        a1, m1, b1 = plan_fn(st, mean, jnp.asarray(0.3), k)
        np.testing.assert_allclose(np.asarray(a1), np.asarray(a0), atol=1e-5)

    def test_sharded_plan_with_fused_spectral_kernel(self, devices8,
                                                     spectral_kernel_interpreted):
        """The whole-horizon kernel has a multi-device route through the
        SAME planner."""
        from plasma_control_tpu.parallel.pic_shard import make_sharded_plan

        cfg, mpc, ctrl, grid, act, st = self._setup(plan_kernel="fused")
        mesh = make_mesh(axis_names=("rollout",))
        plan_fn = make_sharded_plan(mesh, grid, cfg, ctrl, mpc, act)
        mean = jnp.zeros((4, 4))
        k = jax.random.PRNGKey(9)
        a1, m1, b1 = plan_fn(st, mean, jnp.asarray(0.3), k)
        # reference: single-device XLA path (kernel runs in interpret mode on
        # CPU inside shard_map; costs agree to fp32 reassociation)
        mpc_xla = MPCConfig(horizon=4, n_candidates=32, plan_modes=4, plan_kernel="xla")
        a0, m0, b0 = plan(st, mean, jnp.asarray(0.3), k, grid, cfg, ctrl, mpc_xla, act)
        np.testing.assert_allclose(np.asarray(a1), np.asarray(a0), rtol=1e-3, atol=1e-4)

    def test_sharded_closed_loop_rollout(self, devices8):
        """make_sharded_mpc_rollout == mpc_rollout on the virtual mesh."""
        from plasma_control_tpu.control.mpc import mpc_rollout
        from plasma_control_tpu.parallel.pic_shard import make_sharded_mpc_rollout

        cfg, mpc, ctrl, grid, act, st = self._setup()
        mesh = make_mesh(axis_names=("rollout",))
        roll_fn = make_sharded_mpc_rollout(mesh, grid, cfg, ctrl, mpc, act)
        out_s = roll_fn(st, jax.random.PRNGKey(1), n_steps=5)
        out_r = mpc_rollout(st, grid, cfg, ctrl, mpc, act, jax.random.PRNGKey(1), n_steps=5)
        assert np.isfinite(np.asarray(out_s.field_energy)).all()
        np.testing.assert_allclose(
            np.asarray(out_s.field_energy), np.asarray(out_r.field_energy), rtol=5e-3
        )
        np.testing.assert_allclose(
            np.asarray(out_s.coeffs[0]), np.asarray(out_r.coeffs[0]), atol=1e-4
        )

    def test_uneven_candidate_split_rejected(self, devices8):
        from plasma_control_tpu.parallel.pic_shard import make_sharded_plan

        cfg, _, ctrl, grid, act, st = self._setup()
        mpc = MPCConfig(horizon=4, n_candidates=30)  # 30 % 8 != 0
        mesh = make_mesh(axis_names=("rollout",))
        with pytest.raises(ValueError, match="divide evenly"):
            make_sharded_plan(mesh, grid, cfg, ctrl, mpc, act)

    def test_sharded_plan_wrapper_caches(self, devices8):
        """The compatibility wrapper must not rebuild its closure per call."""
        from plasma_control_tpu.parallel import pic_shard

        cfg, mpc, ctrl, grid, act, st = self._setup()
        mesh = make_mesh(axis_names=("rollout",))
        pic_shard._SHARDED_PLANS.clear()
        mean = jnp.zeros((4, 4))
        pic_shard.sharded_plan(st, mean, jnp.asarray(0.3), jax.random.PRNGKey(0), mesh, grid, cfg, ctrl, mpc, act)
        assert len(pic_shard._SHARDED_PLANS) == 1
        fn = next(iter(pic_shard._SHARDED_PLANS.values()))
        pic_shard.sharded_plan(st, mean, jnp.asarray(0.3), jax.random.PRNGKey(1), mesh, grid, cfg, ctrl, mpc, act)
        assert len(pic_shard._SHARDED_PLANS) == 1
        assert next(iter(pic_shard._SHARDED_PLANS.values())) is fn

    def test_sharded_plan_with_twin_correction(self, devices8):
        """Noise-corrected subsampled planning (plan_correction="twin")
        sharded over the rollout axis == the single-device corrected solve:
        the replicated (H, Km) twin targets cross into shard_map as explicit
        broadcast args."""
        from plasma_control_tpu.parallel.pic_shard import make_sharded_plan

        cfg, mpc, ctrl, grid, act, st = self._setup(
            plan_particles=512, plan_correction="twin"
        )
        mesh = make_mesh(axis_names=("rollout",))
        plan_fn = make_sharded_plan(mesh, grid, cfg, ctrl, mpc, act)
        mean = jnp.zeros((4, 4))
        k = jax.random.PRNGKey(11)
        a0, m0, b0 = plan(st, mean, jnp.asarray(0.3), k, grid, cfg, ctrl, mpc, act)
        a1, m1, b1 = plan_fn(st, mean, jnp.asarray(0.3), k)
        np.testing.assert_allclose(np.asarray(a1), np.asarray(a0), atol=1e-5)
        np.testing.assert_allclose(np.asarray(m1), np.asarray(m0), atol=1e-5)
