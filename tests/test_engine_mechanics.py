"""The dynamic engine's mechanics: padding, overflow and the capacity
ladder, exact push counts, the self-compacting output, the kernel route
(compiled on the GPU, interpreted on the CPU, refused elsewhere) and the
no-fallback scheduler lookup."""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_simulation_tpu import cli, runtime, setup_particles
from particle_simulation_tpu.constants import STATUS_ALIVE
from particle_simulation_tpu.ops import gpu_engine
from particle_simulation_tpu.ops.step import _step_config
from particle_simulation_tpu.runtime import sorted_particle_array
from particle_simulation_tpu.schedulers import (
    get_mobility_phase,
    mobility_phase_naive,
    mobility_phase_sync,
)

from engine_cases import BASE, assert_engine_matches_sync, run_steps, spiky_table


# ---- padding: the last program of a generation is partly empty ----

@pytest.mark.parametrize(
    "capacity,init_n,block",
    [(1000, 150, 64), (4097, 203, 32), (1030, 100, 128), (4000, 199, 16)],
    ids=["cap1000-b64", "cap4097-b32", "cap1030-b128", "cap4000-b16"],
)
def test_padding_matches_sync(const_table, capacity, init_n, block):
    cfg = BASE.replace(capacity=capacity, init_n=init_n, block_size=block)
    metrics = assert_engine_matches_sync(cfg, const_table)
    assert not any(m["overflow"] for m in metrics)


# ---- overflow and the capacity ladder ----

def test_overflow_flag_at_top_bucket(const_table):
    """A container too small for the step's children raises ``overflow``;
    the dropped lanes are counted but never stored past the capacity."""
    cfg = BASE.replace(scheduler="dynamic", init_n=220, capacity=256,
                       poisson_steps=1, rng_mode="perstep")
    state, metrics = run_steps(cfg, const_table)
    assert metrics[-1]["overflow"]
    assert 0 < int(state.n) <= cfg.capacity
    status = np.asarray(state.status)
    assert (status[: int(state.n)] == STATUS_ALIVE).all()


def test_bucket_ladder_redo_is_exact(monkeypatch):
    """An overflowing step at a small bucket is redone one bucket up
    (runtime._bucketed_step) and then matches the sync oracle run in a
    container that never overflows."""
    monkeypatch.setattr(
        runtime, "_bucket_size", functools.partial(runtime._bucket_size, floor=64)
    )
    table = spiky_table()
    cfg = BASE.replace(scheduler="dynamic", init_n=200, capacity=4096,
                       init_vth=1e6, poisson_timestep=8)
    state = setup_particles(cfg)
    w_first = runtime._bucket_size(cfg.init_n, cfg.capacity)
    redone = False
    ms = []
    for t in range(2):
        w_start = runtime._bucket_size(int(state.n), cfg.capacity)
        state, m, w = runtime._bucketed_step(state, jnp.uint32(t), table, cfg)
        redone |= w > w_start
        ms.append({k: int(v) for k, v in m.items() if k != "pushes"})
    assert redone and w > w_first
    assert not any(m["overflow"] for m in ms)
    ref, ref_m = run_steps(cfg.replace(scheduler="sync"), table)
    assert [m["n"] for m in ms] == [m["n"] for m in ref_m]
    assert [m["added"] for m in ms] == [m["added"] for m in ref_m]
    np.testing.assert_array_equal(
        sorted_particle_array(state), sorted_particle_array(ref)
    )


# ---- exact push counts ----

def test_push_count_without_collisions():
    """No collisions and a periodic box: every electron is pushed every
    mobility step, so the count is exactly init_n * T per Poisson step."""
    table = jnp.zeros((10_000, 2), jnp.float32)
    cfg = BASE.replace(scheduler="dynamic", boundary="periodic",
                       init_vth=1e6, init_n=333, poisson_timestep=7)
    _state, metrics = run_steps(cfg, table)
    assert [m["pushes"] for m in metrics] == [333 * 7] * cfg.poisson_steps
    assert all(m["added"] == m["removed"] == 0 for m in metrics)


def test_push_count_matches_sync(const_table):
    metrics = assert_engine_matches_sync(
        BASE.replace(poisson_timestep=9, poisson_steps=3), const_table
    )
    # children push from the step after their birth: more than the
    # population alone would give
    assert metrics[0]["pushes"] > BASE.init_n


@pytest.mark.parametrize(
    "partials",
    [
        [0],
        [(1 << 31) - 1] * 3,
        [(1 << 30) - 1, 1, (1 << 30) + 5],
        list(range(0, 1 << 31, 1 << 20)),
    ],
    ids=["zero", "max-i32", "carry", "many-programs"],
)
def test_exact_push_pair(partials):
    lo, hi = gpu_engine.exact_push_pair(jnp.asarray(partials, jnp.int32))
    assert 0 <= int(lo) < (1 << 30)
    assert int(lo) + (int(hi) << 30) == sum(partials)


# ---- the self-compacting output ----

def test_output_is_compacted(const_table):
    """All lanes in [0, n) live and ALIVE, all lanes beyond EMPTY."""
    cfg = BASE.replace(scheduler="dynamic")
    state, metrics = run_steps(cfg, const_table)
    n = int(state.n)
    status = np.asarray(state.status)
    assert n == metrics[-1]["n"]
    assert (status[:n] == STATUS_ALIVE).all()
    assert (status[n:] == 0).all()
    assert gpu_engine.mobility_phase_dynamic.self_compacting


def test_device_loop_matches_sync(const_table):
    """The engine inside the device-resident scan (ops/step.poisson_loop,
    via run_pic_device) agrees with the sync oracle."""
    cfg = BASE.replace(poisson_steps=3)
    eng = runtime.run_pic_device(cfg.replace(scheduler="dynamic"),
                                 table=const_table)
    ref = runtime.run_pic_device(cfg.replace(scheduler="sync"),
                                 table=const_table)
    assert [(s.n, s.added, s.removed) for s in eng.steps] == [
        (s.n, s.added, s.removed) for s in ref.steps
    ]
    np.testing.assert_array_equal(
        sorted_particle_array(eng.state), sorted_particle_array(ref.state)
    )


# ---- configuration checks ----

@pytest.mark.parametrize("block", [0, 8, 24, 100, 257])
def test_block_size_rejected(block):
    with pytest.raises(ValueError, match="power of two"):
        gpu_engine.check_block_size(block)


@pytest.mark.parametrize(
    "block,warps", [(16, 1), (64, 1), (128, 2), (256, 4), (1024, 8)]
)
def test_block_size_accepted(block, warps):
    gpu_engine.check_block_size(block)
    assert gpu_engine.num_warps(block) == warps


def test_f64_state_rejected(const_table):
    cfg = BASE.replace(scheduler="dynamic")
    state = setup_particles(cfg)
    state = state._replace(pos=state.pos.astype(jnp.float16))
    with pytest.raises(ValueError, match="f32-only"):
        gpu_engine.mobility_phase_dynamic(
            state, jnp.uint32(0), const_table, cfg, jnp.int32(2)
        )


def test_block_size_reaches_the_engine_only():
    """The CLI's BLOCK_SIZE positional is the engine's lanes per program;
    the XLA cadences ignore it, so it leaves their compile key."""
    opts = cli.parse_args(["30", "0", "100", "1", "64", "1000", "0", "5"])
    assert opts.config.scheduler == "dynamic"
    assert _step_config(opts.config).block_size == 64
    naive = cli.parse_args(["32", "0", "100", "1", "64", "1000", "0", "5"])
    assert _step_config(naive.config).block_size == 0


def test_mode_33_refused():
    with pytest.raises(SystemExit, match="30.*31.*32"):
        cli.parse_args(["33", "0", "100", "1", "256", "1000", "0", "5"])


# ---- kernel route and scheduler lookup: no silent fallback ----

@pytest.mark.parametrize(
    "backend,interpret",
    [("gpu", False), ("cpu", True), ("rocm", None), ("metal", None)],
)
def test_kernel_route(monkeypatch, backend, interpret):
    monkeypatch.setattr(gpu_engine.jax, "default_backend", lambda: backend)
    if interpret is None:
        with pytest.raises(RuntimeError, match="no kernel for backend"):
            gpu_engine.kernel_route()
    else:
        assert gpu_engine.kernel_route() is interpret


@pytest.mark.parametrize(
    "name,fn",
    [
        ("dynamic", gpu_engine.mobility_phase_dynamic),
        ("sync", mobility_phase_sync),
        ("naive", mobility_phase_naive),
    ],
)
def test_get_mobility_phase(name, fn):
    assert get_mobility_phase(name) is fn


@pytest.mark.parametrize("name", ["dynamic_old", "worklog", ""])
def test_get_mobility_phase_unknown(name):
    with pytest.raises(ValueError, match="mode 30"):
        get_mobility_phase(name)


def test_get_mobility_phase_does_not_fall_back(monkeypatch):
    """An engine that cannot be imported is an error, never a silent
    switch to another cadence."""
    monkeypatch.setitem(sys.modules, "particle_simulation_tpu.ops.gpu_engine",
                        None)
    with pytest.raises(ImportError):
        get_mobility_phase("dynamic")


# ---- on the card ----

@pytest.fixture()
def gpu_backend():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with PARTICLE_SIM_TEST_GPU=1 on a card")


@pytest.mark.gpu
def test_compiled_engine_matches_sync(gpu_backend, const_table):
    """The Triton-compiled engine against the sync oracle on the card."""
    assert gpu_engine.kernel_route() is False
    assert_engine_matches_sync(BASE.replace(block_size=128), const_table)
